"""Port vs reference: the whole streaming ``LifecycleEngine`` slice.

A JAX engine and a port engine (on the CPU) take the same synth stream
through four rollovers with ``CompactionPolicy(fanout=2)``.  After every
batch the seven pool-state leaves, the frozen CSRs, tiers and counters
must be equal; then every query kind — batched and ``batched=False``,
with and without the kernel routes — must return the reference's
docids exactly.  The carry-across functions move a mid-stream state
between the packages in both directions, after which both keep
computing the same thing.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import lifecycle as jl
from repro.core import pointers as jp
from repro.core import segments as jseg
from repro.core import slicepool as jsp
from repro.data import synth
from repro_torch.core import convert
from repro_torch.core import lifecycle as tl
from repro_torch.core import pointers as tp
from repro_torch.core import segments as tseg

from conftest import max_slices_for

VOCAB, N_DOCS, SEG, BATCH = 1500, 2000, 400, 100


@pytest.fixture(scope="module")
def stream():
    spec = synth.CorpusSpec(vocab=VOCAB, n_docs=N_DOCS, seed=3)
    docs = synth.zipf_corpus(spec)
    freqs = synth.term_freqs(docs, VOCAB)
    z, spp = (1, 4, 7, 11), (4096, 2048, 1024, 512)
    qs = synth.query_log("aol", 12, docs, VOCAB, seed=4)
    queries = [tuple(int(t) for t in r if t >= 0) for r in qs]
    pairs = [(int(docs[d, 0]), int(docs[d, 1])) for d in range(0, 1800, 300)]
    pairs += [(q[0], q[-1]) for q in queries[:6]]
    return dict(docs=docs, z=z, spp=spp, queries=queries, pairs=pairs,
                max_slices=max_slices_for(z, freqs),
                max_len=1 << int(freqs.max()).bit_length())


def make_pair(s, **kw):
    j = jl.LifecycleEngine(
        jp.PoolLayout(z=s["z"], slices_per_pool=s["spp"]), VOCAB, SEG,
        max_slices=s["max_slices"], max_len=s["max_len"], max_query_len=4,
        compaction=jseg.CompactionPolicy(fanout=2), **kw)
    t = tl.LifecycleEngine(
        tp.PoolLayout(z=s["z"], slices_per_pool=s["spp"]), VOCAB, SEG,
        max_slices=s["max_slices"], max_len=s["max_len"], max_query_len=4,
        compaction=tseg.CompactionPolicy(fanout=2), device="cpu", **kw)
    return j, t


def assert_engines_equal(j, t, ctx=""):
    want = {f: np.asarray(getattr(j.segments.active.state, f))
            for f in jsp.PoolState._fields}
    got = convert.pool_state_to_numpy(t.segments.active.state)
    for f in want:
        assert np.array_equal(want[f], got[f]), f"{ctx}: leaf {f}"
    assert len(j.segments.frozen) == len(t.segments.frozen), ctx
    for a, b in zip(j.segments.frozen, t.segments.frozen):
        np.testing.assert_array_equal(b.offsets, a.offsets)
        np.testing.assert_array_equal(b.data, a.data)
        assert (a.n_docs, a.doc_base, a.tier) == (b.n_docs, b.doc_base,
                                                  b.tier)
    assert j.segments.active.next_docid == t.segments.active.next_docid
    assert j.doc_base == t.doc_base
    for f in ("docs_ingested", "rollovers", "compactions",
              "high_water_slots", "live_slots"):
        assert getattr(j.stats, f) == getattr(t.stats, f), f


def assert_answers_equal(j, t, s):
    for name, args in (("conjunctive_batch", (s["queries"],)),
                       ("disjunctive_batch", (s["queries"],)),
                       ("phrase_batch", (s["pairs"],)),
                       ("topk_conjunctive_batch", (s["queries"], 7)),
                       ("conjunctive_batch", (s["queries"], 30)),
                       ("disjunctive_batch", (s["queries"], None, True))):
        want = getattr(j, name)(*args)
        got = getattr(t, name)(*args)
        assert len(want) == len(got)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module")
def streamed(stream):
    j, t = make_pair(stream)
    docs = stream["docs"]
    for i in range(0, N_DOCS - BATCH // 2, BATCH):
        j.ingest(docs[i: i + BATCH])
        t.ingest(docs[i: i + BATCH])
        assert_engines_equal(j, t, f"batch {i // BATCH}")
    j.ingest(docs[N_DOCS - BATCH // 2:])      # a ragged last batch
    t.ingest(docs[N_DOCS - BATCH // 2:])
    assert t.stats.rollovers >= 3 and t.stats.compactions >= 1
    return j, t


def test_state_and_frozen_csrs_match(streamed):
    j, t = streamed
    assert_engines_equal(j, t, "end of stream")
    assert [fz.tier for fz in t.segments.frozen] == \
        [fz.tier for fz in j.segments.frozen]


@pytest.mark.parametrize("route", ["batched", "batched_kernel",
                                   "sequential", "sequential_plain"])
def test_every_query_kind_matches(stream, streamed, route):
    j, t = streamed
    t.batched = route.startswith("batched")
    t._batched_kernel = route == "batched_kernel"
    t.use_kernel = route != "sequential_plain"
    try:
        assert_answers_equal(j, t, stream)
    finally:
        t.batched, t._batched_kernel, t.use_kernel = True, False, True


def test_single_query_api_and_dispatch_match(stream, streamed):
    j, t = streamed
    q = stream["queries"][0]
    for name in ("conjunctive", "disjunctive"):
        np.testing.assert_array_equal(getattr(t, name)(q),
                                      getattr(j, name)(q))
    np.testing.assert_array_equal(t.phrase(*stream["pairs"][0]),
                                  j.phrase(*stream["pairs"][0]))
    np.testing.assert_array_equal(t.topk_conjunctive(q, 3),
                                  j.topk_conjunctive(q, 3))
    for kind, kw in (("topk", dict(k=4)), ("conjunctive", {}),
                     ("disjunctive", dict(limit=9)), ("phrase", {})):
        qs = stream["pairs"] if kind == "phrase" else stream["queries"]
        want = j.dispatch(kind, qs, **kw).wait()
        got = t.dispatch(kind, qs, **kw).wait()
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)


def test_scored_and_sharded_not_ported(stream, streamed, monkeypatch):
    """Scored retrieval is ported (it answers like the reference); the
    sharded engine builds on the CPU and answers like the single-device
    one (``tests/test_torch_sharded_lifecycle.py`` holds it against the
    reference).  A ``validate=True`` engine validates at every rollover
    and compaction and ends in the reference's state."""
    j, t = streamed
    q = stream["queries"][0]
    for got, want in ((t.scored_topk(q, 3), j.scored_topk(q, 3)),
                      (t.dispatch("scored", [q], k=3).wait()[0],
                       j.dispatch("scored", [q], k=3).wait()[0])):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    from repro_torch.core.sharded_index import make_doc_mesh
    sh = tl.ShardedLifecycleEngine(
        tp.PoolLayout(z=stream["z"], slices_per_pool=stream["spp"]), VOCAB,
        SEG, make_doc_mesh(4, device="cpu"), max_slices=stream["max_slices"],
        max_len=stream["max_len"], max_query_len=4, device="cpu")
    sh.ingest(stream["docs"][:BATCH])
    np.testing.assert_array_equal(sh.conjunctive(q), j.conjunctive(q)[
        j.conjunctive(q) < BATCH])
    _, v = make_pair(stream, validate=True)
    calls = []
    real = tl.LifecycleEngine.validate_invariants
    monkeypatch.setattr(tl.LifecycleEngine, "validate_invariants",
                        lambda self: calls.append(real(self)))
    docs = stream["docs"]
    for i in range(0, N_DOCS - BATCH // 2, BATCH):
        v.ingest(docs[i: i + BATCH])
    v.ingest(docs[N_DOCS - BATCH // 2:])
    assert v.validate
    assert len(calls) == v.stats.rollovers >= 3     # one per rollover
    assert_engines_equal(j, v, "validate=True")


def _jax_dump(j):
    segs = j.segments
    return dict(
        leaves={f: np.asarray(getattr(segs.active.state, f))
                for f in jsp.PoolState._fields},
        frozen=list(segs.frozen), next_docid=segs.active.next_docid,
        doc_base=segs._doc_base, n_rollovers=segs.n_rollovers,
        n_compactions=segs.n_compactions)


def _jax_load(j, d):
    """The reverse carry: a port dump into a reference engine."""
    segs = j.segments
    state = jsp.PoolState(**{f: jnp.asarray(v)
                             for f, v in d["leaves"].items()})
    segs.active = segs._new_active(state=state)
    segs.active.next_docid = d["next_docid"]
    segs.frozen = [jseg.FrozenSegment(offsets=f["offsets"], data=f["data"],
                                      n_docs=f["n_docs"],
                                      doc_base=f["doc_base"],
                                      tier=f["tier"]) for f in d["frozen"]]
    segs._doc_base = d["doc_base"]
    segs.n_rollovers, segs.n_compactions = d["n_rollovers"], \
        d["n_compactions"]
    j._sync_frozen()


def _copy_stats(src, dst):
    # counters are bookkeeping of the engine object, not index state
    for f in dataclasses.fields(dst.stats):
        setattr(dst.stats, f.name, getattr(src.stats, f.name))


def test_carry_across_both_ways_mid_stream(stream):
    docs = stream["docs"]
    j, t = make_pair(stream)
    cut = 1100                                  # mid-segment, 2 rollovers
    for i in range(0, cut, BATCH):
        j.ingest(docs[i: i + BATCH])
    # reference -> port
    convert.load_lifecycle(t, **_jax_dump(j))
    _copy_stats(j, t)
    assert_engines_equal(j, t, "after load")
    # port -> reference: a fresh reference engine from the port's dump
    j2, _ = make_pair(stream)
    _jax_load(j2, convert.dump_lifecycle(t))
    _copy_stats(t, j2)
    for i in range(cut, N_DOCS, BATCH):
        for eng in (j, t, j2):
            eng.ingest(docs[i: i + BATCH])
    assert_engines_equal(j, t, "continued")
    assert_engines_equal(j2, t, "continued from the port's dump")
    assert_answers_equal(j, t, stream)
    assert_answers_equal(j2, t, stream)


def test_segment_set_helpers_match(stream, streamed):
    j, t = streamed
    np.testing.assert_array_equal(t.segments.history_freqs(),
                                  j.segments.history_freqs())
    for term in {q[0] for q in stream["queries"]}:
        for limit in (3, 10_000):
            np.testing.assert_array_equal(
                t.segments.search_term_desc(term, t.engine, limit),
                j.segments.search_term_desc(term, j.engine, limit))


@pytest.mark.parametrize("admission", [
    dict(rollover_at=0.6),
    dict(rollover_at=0.0, shed_at=0.05, min_segment_docs=150)])
def test_admission_pressure_decisions_match(admission):
    """Pools too small for the stream: emergency rollovers, shed batches
    and the resulting states follow the reference decision for
    decision."""
    spec = synth.CorpusSpec(vocab=300, n_docs=1200, seed=11)
    docs = synth.zipf_corpus(spec)
    z, spp = (1, 4, 7, 11), (256, 96, 24, 6)
    kw = dict(max_slices=64, max_len=64, use_kernel=False)
    j = jl.LifecycleEngine(jp.PoolLayout(z=z, slices_per_pool=spp), 300,
                           100_000, admission=jl.AdmissionController(
                               **admission), **kw)
    t = tl.LifecycleEngine(tp.PoolLayout(z=z, slices_per_pool=spp), 300,
                           100_000, admission=tl.AdmissionController(
                               **admission), device="cpu", **kw)
    for i in range(0, 1200, 40):
        assert j.ingest(docs[i: i + 40]) == t.ingest(docs[i: i + 40])
        assert_engines_equal(j, t, f"batch {i // 40}")
    for f in ("emergency_rollovers", "deferred_batches", "shed_batches"):
        assert getattr(j.stats, f) == getattr(t.stats, f), f
    assert t.stats.emergency_rollovers + t.stats.shed_batches > 0
    assert bool(j.segments.active.state.overflow) == \
        bool(t.segments.active.state.overflow)
