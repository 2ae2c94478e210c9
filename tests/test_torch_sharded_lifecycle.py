"""Port vs reference: the document-sharded streaming engine.

A port ``ShardedLifecycleEngine`` over four shards (on the CPU) and a
JAX single-device ``LifecycleEngine`` take the same stream across
rollovers and a compaction; every query kind — batched and
``batched=False``, top-k at several k, scored top-k and exhaustive
scored — must return the reference's answers exactly (the reference's
own sharded and single-device engines agree: ``tests/test_qexec.py``).
The validators check a sharded engine shard by shard, and the serving
loop runs over a sharded engine with admission stats equal to the
single-device engine's (``tests/test_serve.py``'s sharded script).
"""
import numpy as np
import pytest

from repro.core import lifecycle as jl
from repro.core import pointers as jp
from repro.core import segments as jseg
from repro.data import synth
from repro_torch.analysis import invariants as tinv
from repro_torch.core import lifecycle as tl
from repro_torch.core import pointers as tp
from repro_torch.core import segments as tseg
from repro_torch.core import serve as tsv
from repro_torch.core.sharded_index import ShardedFrozenSegment, make_doc_mesh

from conftest import max_slices_for

Z, SPP = (1, 4, 7, 11), (4096, 2048, 512, 64)
VOCAB, N_DOCS, SEG, BATCH, S = 400, 440, 120, 40, 4


@pytest.fixture(scope="module")
def stream():
    spec = synth.CorpusSpec(vocab=VOCAB, n_docs=N_DOCS, seed=17)
    docs = synth.zipf_corpus(spec)
    freqs = synth.term_freqs(docs, VOCAB)
    top = [int(t) for t in np.argsort(-freqs)]
    queries = [(top[0], top[1]), (top[2], top[5]), (top[9],),
               (top[1], top[3], top[7]), (top[0], VOCAB - 1),
               (top[0], top[2], top[4], top[6])]
    pairs = [(top[0], top[1]), (top[2], top[0]),
             (int(docs[3, 0]), int(docs[3, 1]))]
    return dict(docs=docs, queries=queries, pairs=pairs,
                max_slices=max_slices_for(Z, freqs),
                max_len=1 << (int(freqs.max()) - 1).bit_length())


@pytest.fixture(scope="module")
def engines(stream):
    j = jl.LifecycleEngine(
        jp.PoolLayout(z=Z, slices_per_pool=SPP), VOCAB, SEG,
        max_slices=stream["max_slices"], max_len=stream["max_len"],
        max_query_len=4, compaction=jseg.CompactionPolicy(fanout=2),
        use_kernel=False)
    t = tl.ShardedLifecycleEngine(
        tp.PoolLayout(z=Z, slices_per_pool=SPP), VOCAB, SEG,
        make_doc_mesh(S, device="cpu"), max_slices=stream["max_slices"],
        max_len=stream["max_len"], max_query_len=4,
        compaction=tseg.CompactionPolicy(fanout=2), device="cpu")
    docs = stream["docs"]
    for i in range(0, N_DOCS, BATCH):
        j.ingest(docs[i: i + BATCH])
        t.ingest(docs[i: i + BATCH])
    assert t.stats.rollovers == j.stats.rollovers >= 3
    assert t.stats.compactions == j.stats.compactions >= 1
    assert t.segments.active.next_docid > 0       # a live active part
    return j, t


def test_sharded_segments_tile_like_the_reference(engines):
    j, t = engines
    assert t.doc_base == j.doc_base
    assert [(f.doc_base, f.n_docs, f.tier) for f in t.segments.frozen] == \
        [(f.doc_base, f.n_docs, f.tier) for f in j.segments.frozen]
    for fj, ft in zip(j.segments.frozen, t.segments.frozen):
        assert isinstance(ft, ShardedFrozenSegment)
        assert len(ft.shards) == S
        np.testing.assert_array_equal(ft.term_freqs(), fj.term_freqs())
        for term in range(0, VOCAB, 37):
            np.testing.assert_array_equal(ft.docids_desc(term),
                                          fj.docids_desc(term))
            assert ft.docid_bounds(term) == fj.docid_bounds(term)
    np.testing.assert_array_equal(t.segments.history_freqs(),
                                  j.segments.history_freqs())
    assert tinv.check_engine(t).ok


def test_frozen_members_and_merged_postings(engines):
    """A sharded segment's members are its shards and its merged
    postings are the single-device segment's; a single-device segment
    is its own only member."""
    j, t = engines
    for fj, ft in zip(j.segments.frozen, t.segments.frozen):
        assert ft.members is ft.shards
        for term in range(0, VOCAB, 37):
            np.testing.assert_array_equal(ft.postings(term),
                                          np.asarray(fj.postings(term)))
    shard = t.segments.frozen[0].shards[0]
    assert shard.members == [shard]


@pytest.mark.parametrize("batched", [True, False])
def test_every_query_kind_matches_the_single_device_reference(
        stream, engines, batched):
    j, t = engines
    qs, pairs = stream["queries"], stream["pairs"]
    t.batched = batched
    try:
        calls = [("conjunctive_batch", (qs,)), ("disjunctive_batch", (qs,)),
                 ("phrase_batch", (pairs,)), ("conjunctive_batch", (qs, 9)),
                 ("disjunctive_batch", (qs, None, True))]
        calls += [("topk_conjunctive_batch", (qs, k)) for k in (1, 4, 40)]
        for name, args in calls:
            for w, g in zip(getattr(j, name)(*args), getattr(t, name)(*args)):
                np.testing.assert_array_equal(g, w, err_msg=name)
        for name, args in (("scored_topk_batch", (qs, 3)),
                           ("scored_full_batch", (qs,)),
                           ("scored_full_batch", (qs, 5))):
            for (wi, ws), (gi, gs) in zip(getattr(j, name)(*args),
                                          getattr(t, name)(*args)):
                np.testing.assert_array_equal(gi, wi, err_msg=name)
                np.testing.assert_array_equal(gs, ws, err_msg=name)
        for kind, kw in (("topk", dict(k=4)), ("scored", dict(k=2)),
                         ("scored_full", {}), ("phrase", {})):
            batch = pairs if kind == "phrase" else qs
            for w, g in zip(j.dispatch(kind, batch, **kw).wait(),
                            t.dispatch(kind, batch, **kw).wait()):
                for a, b in zip(w if kind.startswith("scored") else (w,),
                                g if kind.startswith("scored") else (g,)):
                    np.testing.assert_array_equal(b, a, err_msg=kind)
    finally:
        t.batched = True


def test_single_query_api_and_search_term(stream, engines):
    j, t = engines
    q = stream["queries"][3]
    for name in ("conjunctive", "disjunctive"):
        np.testing.assert_array_equal(getattr(t, name)(q),
                                      getattr(j, name)(q))
    np.testing.assert_array_equal(t.phrase(*stream["pairs"][0]),
                                  j.phrase(*stream["pairs"][0]))
    for g, w in zip(t.scored_topk(q, 2), j.scored_topk(q, 2)):
        np.testing.assert_array_equal(g, w)
    term = q[0]
    np.testing.assert_array_equal(
        t.segments.search_term_desc(term, t.engine, 25),
        j.segments.search_term_desc(term, j.engine, 25))
    codecs, total = t.segments.frozen[-1].compress()
    assert len(codecs) == S and total > 0


def test_validate_checks_every_shard_and_catches_a_broken_one(stream):
    """``validate=True`` runs ``check_engine`` at every rollover; a
    shard member whose CSR is broken is reported by shard."""
    eng = tl.ShardedLifecycleEngine(
        tp.PoolLayout(z=Z, slices_per_pool=SPP), VOCAB, SEG,
        make_doc_mesh(S, device="cpu"), max_slices=stream["max_slices"],
        max_len=stream["max_len"], validate=True, device="cpu")
    for i in range(0, 2 * SEG, BATCH):
        eng.ingest(stream["docs"][i: i + BATCH])
    assert eng.stats.rollovers == 2
    rep = tinv.check_engine(eng)
    assert rep.ok and rep.stats["shards"] == S
    sh = eng.segments.frozen[0].shards[2]
    sh.data[:] = sh.data[::-1].copy()
    with pytest.raises(tinv.InvariantViolation, match="shard 2"):
        eng.validate_invariants()


def test_mesh_and_engine_must_share_a_device():
    with pytest.raises(ValueError, match="mesh shards live on"):
        tl.ShardedLifecycleEngine(
            tp.PoolLayout(z=Z, slices_per_pool=SPP), VOCAB, SEG,
            make_doc_mesh(S, device="meta"), max_slices=8, max_len=8,
            device="cpu")
    with pytest.raises(ValueError, match="multiple of the shard count"):
        tl.ShardedLifecycleEngine(
            tp.PoolLayout(z=Z, slices_per_pool=SPP), VOCAB, 121,
            make_doc_mesh(S, device="cpu"), max_slices=8, max_len=8,
            device="cpu")


def _sym_batches(n, V=64):
    out, d = [], 0
    for _ in range(n):
        out.append(np.arange(d, d + V, dtype=np.int64).reshape(V, 1) % V)
        d += V
    return out


def test_sharded_admission_and_serving_agree_with_single_device():
    """The reference's sharded serving script on the port: per-shard
    pools a quarter of the single-device pools over a stream that splits
    term for term across shards give the same utilization trajectory,
    so emergency rollovers and sheds agree batch for batch; a shed batch
    lands after a rollover; the ServeLoop runs unmodified over the
    sharded engine (the worst shard sets its pool gauge) and answers
    like the JAX single-device engine at rungs 0 and 3."""
    mesh = make_doc_mesh(4, device="cpu")

    def mk(adm, sharded, pkg=tl, pts=tp):
        if sharded:
            return tl.ShardedLifecycleEngine(
                tp.PoolLayout(z=Z, slices_per_pool=(64, 24, 6, 2)), 128,
                100_000, mesh, max_slices=64, max_len=64, use_kernel=False,
                admission=adm, device="cpu")
        kw = dict(device="cpu") if pkg is tl else {}
        return pkg.LifecycleEngine(
            pts.PoolLayout(z=Z, slices_per_pool=(256, 96, 24, 8)), 128,
            100_000, max_slices=64, max_len=64, use_kernel=False,
            admission=adm, **kw)

    batches = _sym_batches(30)
    e1 = mk(tl.AdmissionController(rollover_at=0.6), False)
    e4 = mk(tl.AdmissionController(rollover_at=0.6), True)
    ej = mk(jl.AdmissionController(rollover_at=0.6), False, jl, jp)
    for docs in batches:
        assert e1.ingest(docs) and e4.ingest(docs) and ej.ingest(docs)
    assert e1.stats.emergency_rollovers == e4.stats.emergency_rollovers \
        == ej.stats.emergency_rollovers > 0
    assert e1.stats.shed_batches == e4.stats.shed_batches == 0

    def adm():
        return tl.AdmissionController(rollover_at=0.6, shed_at=0.6,
                                      min_segment_docs=10_000)
    h1, h4 = mk(adm(), False), mk(adm(), True)
    for docs in batches:
        assert h1.ingest(docs) == h4.ingest(docs)
    assert h1.stats.shed_batches == h4.stats.shed_batches > 0
    assert h1.stats.docs_ingested == h4.stats.docs_ingested
    assert h4.ingest(batches[0]) is False
    h4.segments.rollover()
    h4._sync_frozen()
    assert h4.ingest(batches[0]) is True

    loop = tsv.ServeLoop(e4, tsv.ServeConfig(default_k=8))
    for level in (0, 3):
        loop.force_level = level
        loop.submit_query("conjunctive", (3, 7), k=8)
        loop.step(force=True)
        (r,) = loop.take_responses()
        full = ej.conjunctive([3, 7])
        if level == 3:
            full = full[full < e4.doc_base][:2]
        np.testing.assert_array_equal(r.docids, full)
    tinv.check_serve(loop).raise_if_failed()
    tinv.check_engine(e4).raise_if_failed()
