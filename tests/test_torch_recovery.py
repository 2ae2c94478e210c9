"""Port vs reference: durable snapshots, the ingest journal and crash
recovery (``repro_torch.core.recovery``).

* The two packages write the same bytes: an archive or a journal of the
  same state is byte-identical, an archive written by either restores
  in the other, and ``engine_fingerprint`` agrees across packages.
* Recovery (restore + journal replay through the ordinary ingest) after
  a crash at several points is bit-identical to the uncrashed engine:
  fingerprint and every query kind, scored included.
* A torn final journal record is dropped; mid-file damage, a flipped
  leaf byte, a truncated archive and a journal short of the durable
  watermark raise ``CorruptSnapshotError``.
"""
import os

import numpy as np
import pytest

from repro.core import lifecycle as jl
from repro.core import pointers as jp
from repro.core import recovery as jrec
from repro.core import segments as jseg
from repro.data import synth
from repro_torch.core import lifecycle as tl
from repro_torch.core import pointers as tp
from repro_torch.core import recovery as trec
from repro_torch.core import segments as tseg

from conftest import max_slices_for

VOCAB, N_DOCS, SEG, BATCH = 600, 1200, 250, 60
Z, SPP = (1, 4, 7, 11), (4096, 2048, 512, 64)


@pytest.fixture(scope="module")
def stream():
    spec = synth.CorpusSpec(vocab=VOCAB, n_docs=N_DOCS, seed=21)
    docs = synth.zipf_corpus(spec)
    freqs = synth.term_freqs(docs, VOCAB)
    qs = synth.query_log("aol", 6, docs, VOCAB, seed=22)
    queries = [tuple(int(t) for t in r if t >= 0) for r in qs]
    batches = [docs[i: i + BATCH] for i in range(0, N_DOCS, BATCH)]
    return dict(batches=batches, queries=queries,
                kw=dict(max_slices=max_slices_for(Z, freqs),
                        max_len=1 << int(freqs.max()).bit_length(),
                        max_query_len=4))


def port_engine(s):
    return tl.LifecycleEngine(
        tp.PoolLayout(z=Z, slices_per_pool=SPP), VOCAB, SEG,
        compaction=tseg.CompactionPolicy(fanout=2),
        admission=tl.AdmissionController(rollover_at=0.97), device="cpu",
        **s["kw"])


def jax_engine(s):
    return jl.LifecycleEngine(
        jp.PoolLayout(z=Z, slices_per_pool=SPP), VOCAB, SEG,
        compaction=jseg.CompactionPolicy(fanout=2),
        admission=jl.AdmissionController(rollover_at=0.97), **s["kw"])


def feed(eng, batches):
    for b in batches:
        eng.ingest(b)
    return eng


def answers(eng, s):
    qs = s["queries"]
    out = [eng.conjunctive_batch(qs), eng.disjunctive_batch(qs),
           eng.topk_conjunctive_batch(qs, 5),
           eng.phrase_batch([(q[0], q[-1]) for q in qs])]
    out += [x for pair in eng.scored_topk_batch(qs, 6) for x in pair]
    out += [x for pair in eng.scored_full_batch(qs) for x in pair]
    return [np.asarray(a) for part in out
            for a in (part if isinstance(part, list) else [part])]


def assert_answers_equal(a, b, s):
    for x, y in zip(answers(a, s), answers(b, s)):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def fed(stream):
    """Both packages' engines after the whole stream (>= 3 rollovers and
    a compaction), with their fingerprints taken before any query."""
    j = feed(jax_engine(stream), stream["batches"])
    t = feed(port_engine(stream), stream["batches"])
    assert t.stats.rollovers >= 3 and t.stats.compactions >= 1
    return j, t, jrec.engine_fingerprint(j), trec.engine_fingerprint(t)


def test_fingerprints_and_archives_agree_across_packages(fed, tmp_path):
    j, t, jfp, tfp = fed
    assert tfp == jfp
    jpath, tpath = str(tmp_path / "j.snap"), str(tmp_path / "t.snap")
    jmeta = jrec.snapshot(j, jpath, seq=20)
    tmeta = trec.snapshot(t, tpath, seq=20)
    assert tmeta == jmeta
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()


def test_archives_cross_restore_both_ways(stream, fed, tmp_path):
    j, t, jfp, tfp = fed
    jpath, tpath = str(tmp_path / "j.snap"), str(tmp_path / "t.snap")
    jrec.snapshot(j, jpath)
    trec.snapshot(t, tpath)
    t_from_j = trec.restore(jpath, device="cpu")
    j_from_t = jrec.restore(tpath)
    assert trec.engine_fingerprint(t_from_j) == jfp
    assert jrec.engine_fingerprint(j_from_t) == tfp
    assert t_from_j.admission == t.admission
    assert t_from_j.segments.compaction.fanout == 2
    # both keep computing the same thing after the crossing
    more = stream["batches"][:3]
    feed(t_from_j, more)
    feed(j_from_t, more)
    assert trec.engine_fingerprint(t_from_j) == \
        jrec.engine_fingerprint(j_from_t)
    assert_answers_equal(t_from_j, j_from_t, stream)


def test_journals_are_byte_identical_and_cross_read(stream, tmp_path):
    paths = []
    for mod, name in ((jrec, "j"), (trec, "t")):
        path = str(tmp_path / f"{name}.jrnl")
        with mod.IngestJournal(path, base_seq=3) as jr:
            for b in stream["batches"][:4]:
                jr.append(b)
        paths.append(path)
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        assert f.read() == g.read()
    for reader, path in ((trec, paths[0]), (jrec, paths[1])):
        base, recs = reader.read_journal(path)
        assert base == 3 and [s for s, _ in recs] == [3, 4, 5, 6]
        for (_, got), want in zip(recs, stream["batches"][:4]):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("snap_at,crash_at", [(0, 5), (4, 9), (9, 20)])
def test_crash_recovery_bit_identical(stream, tmp_path, snap_at, crash_at):
    """Journal every batch, snapshot at ``snap_at``, crash after
    ``crash_at`` batches (the last one journaled but never applied), then
    recover: equal to an uncrashed engine and to the reference."""
    batches = stream["batches"]
    snap, jrnl = str(tmp_path / "s.snap"), str(tmp_path / "s.jrnl")
    eng = port_engine(stream)
    with trec.IngestJournal(jrnl) as jr:
        for i, b in enumerate(batches[:crash_at]):
            if i == snap_at:
                trec.snapshot(eng, snap, seq=i)
            jr.append(b)
            if i < crash_at - 1:        # the crash: last batch unapplied
                eng.ingest(b)
    del eng
    got = trec.recover(snap, jrnl, expect_seq=crash_at, device="cpu")
    want = feed(port_engine(stream), batches[:crash_at])
    ref = feed(jax_engine(stream), batches[:crash_at])
    fp = trec.engine_fingerprint(want)
    assert trec.engine_fingerprint(got) == fp
    assert jrec.engine_fingerprint(ref) == fp
    assert_answers_equal(got, want, stream)
    replayed = []
    trec.recover(snap, jrnl, device="cpu",
                 on_replay=lambda seq, docs, ok: replayed.append((seq, ok)))
    assert replayed == [(i, True) for i in range(snap_at, crash_at)]


def _journal(path, batches):
    """Journal ``batches``; returns each record's start offset."""
    starts = []
    with trec.IngestJournal(path) as jr:
        for b in batches:
            starts.append(jr._f.tell())
            jr.append(b)
    return starts


def test_torn_journal_tail_dropped_and_resumed(stream, tmp_path):
    batches = stream["batches"][:4]
    path = str(tmp_path / "torn.jrnl")
    _journal(path, batches)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 7)            # crash mid-append of record 3
    _, recs = trec.read_journal(path)
    assert [s for s, _ in recs] == [0, 1, 2]
    with trec.IngestJournal(path) as jr:  # resume: torn bytes cut first
        assert jr.next_seq == 3
        jr.append(batches[3])
    _, recs = trec.read_journal(path)
    assert [s for s, _ in recs] == [0, 1, 2, 3]
    np.testing.assert_array_equal(recs[3][1], batches[3])


def _flip(path, offset_from_end):
    with open(path, "r+b") as f:
        f.seek(-offset_from_end, os.SEEK_END)
        byte = f.read(1)
        f.seek(-offset_from_end, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0x5A]))


@pytest.mark.parametrize("damage", ["journal_mid_file", "journal_length",
                                    "leaf_byte", "truncated_archive",
                                    "expect_seq_gap", "snapshot_gap"])
def test_damage_raises_corrupt(stream, fed, tmp_path, damage):
    _, t, _, _ = fed
    batches = stream["batches"][:4]
    snap, jrnl = str(tmp_path / "d.snap"), str(tmp_path / "d.jrnl")
    trec.snapshot(port_engine(stream), snap, seq=0)
    starts = _journal(jrnl, batches)
    kw = {}
    if damage == "journal_mid_file":     # record 1's body, 2 records after
        _flip(jrnl, os.path.getsize(jrnl) - (starts[2] - 5))
    elif damage == "journal_length":     # record 1's length field
        _flip(jrnl, os.path.getsize(jrnl) - starts[1])
    elif damage == "leaf_byte":
        trec.snapshot(t, snap)
        _flip(snap, 100)
    elif damage == "truncated_archive":
        trec.snapshot(t, snap)
        with open(snap, "r+b") as f:
            f.truncate(os.path.getsize(snap) * 2 // 5)
    elif damage == "expect_seq_gap":
        kw = dict(expect_seq=len(batches) + 1)
    else:                                        # journal starts too late
        trec.snapshot(port_engine(stream), snap, seq=0)
        os.remove(jrnl)
        with trec.IngestJournal(jrnl, base_seq=2) as jr:
            jr.append(batches[2])
    with pytest.raises(trec.CorruptSnapshotError):
        trec.recover(snap, jrnl, device="cpu", **kw)


def test_unsupported_archives_name_their_roadmap_item(stream, tmp_path):
    """A single-device archive relabelled ``kind="sharded"`` raises
    ``CorruptSnapshotError``: its pool leaves are not stacked, and with
    them stacked it still lacks the shard leaves of its frozen segments.
    ``validate=True`` restores validate the state (a tampered leaf whose
    CRCs were recomputed restores silently without it and raises with
    it)."""
    from repro_torch.analysis import faults, invariants
    path = str(tmp_path / "x.snap")
    trec.snapshot(feed(port_engine(stream), stream["batches"][:3]), path)
    eng = trec.restore(path, device="cpu", validate=True)
    assert eng.validate and invariants.check_engine(eng).ok
    faults.rewrite_leaf(path, "active/freq", lambda f: f + (f > 0))
    trec.restore(path, device="cpu")
    with pytest.raises(invariants.InvariantViolation, match="freq"):
        trec.restore(path, device="cpu", validate=True)
    meta = trec.snapshot(port_engine(stream), path)
    _, arrays = trec.read_archive(path)
    trec.write_archive(path, dict(meta, kind="sharded", num_shards=2),
                       sorted(arrays.items()))
    with pytest.raises(trec.CorruptSnapshotError, match="active/heap"):
        trec.restore(path, device="cpu")
    rolled = feed(port_engine(stream), stream["batches"][:6])
    assert rolled.stats.rollovers == 1
    meta1 = trec.snapshot(rolled, path)
    _, arrays1 = trec.read_archive(path)
    stacked = {k: (v[None] if k.startswith("active/") else v)
               for k, v in arrays1.items()}
    trec.write_archive(path, dict(meta1, kind="sharded", num_shards=1),
                       sorted(stacked.items()))
    with pytest.raises(trec.CorruptSnapshotError,
                       match="frozen/0/shard0/offsets"):
        trec.restore(path, device="cpu")
    trec.write_archive(path, meta, [(k, v) for k, v in arrays.items()
                                    if k != "active/freq"])
    with pytest.raises(trec.CorruptSnapshotError, match="active/freq"):
        trec.restore(path, device="cpu")
