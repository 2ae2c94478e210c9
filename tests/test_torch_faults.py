"""Port vs reference: the seeded fault-injection harness.

Every ``FaultPlan`` kind runs through both packages' ``run_plan`` (the
port's on the CPU); each asserts the recovery contract itself.  The two
harnesses must agree plan for plan: the same number of acked batches,
the same crash and raise verdicts, and — where recovery succeeds — a
recovered engine with the same ``engine_fingerprint`` and the same
``query_results``.  A reference archive and journal must recover in the
port to the reference's recovered state.
"""
import os

import numpy as np
import pytest

from repro.analysis import faults as JF
from repro.core import recovery as jrec
from repro_torch.analysis import faults as TF
from repro_torch.core import recovery as trec


def _plans():
    plans = [dict(kind=k, seed=3) for k in TF.KINDS]
    plans += [dict(kind=k, seed=7, snapshot_at=s, crash_at=c)
              for k in TF.CRASH_KINDS for s, c in ((1, 0), (4, 4),
                                                   (12, 11))]
    plans += [dict(kind=k, seed=5, admission_rollover_at=0.3)
              for k in TF.CRASH_KINDS]
    plans += [dict(kind="crash_mid_rollover", seed=2,
                   compaction_fanout=None),
              dict(kind="crash_mid_rollover", seed=0, validate=True),
              dict(kind="flip_leaf_byte", seed=1),
              dict(kind="truncate_archive", seed=2)]
    return plans


def _capture(monkeypatch, module):
    """Keep every engine ``module.recover`` returns."""
    got, real = [], module.recover

    def spy(*a, **k):
        got.append(real(*a, **k))
        return got[-1]
    monkeypatch.setattr(module, "recover", spy)
    return got


@pytest.mark.parametrize("plan", _plans(), ids=lambda p: "-".join(
    f"{v}" for v in p.values()))
def test_harnesses_agree(plan, tmp_path, monkeypatch):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jrecovered = _capture(monkeypatch, jrec)
    trecovered = _capture(monkeypatch, trec)
    want = JF.run_plan(JF.FaultPlan(**plan), str(jdir))
    got = TF.run_plan(TF.FaultPlan(**plan), str(tdir), device="cpu")
    assert (got.acked, got.crashed, got.recovered) == \
        (want.acked, want.crashed, want.recovered)
    assert (got.fingerprint_equal, got.queries_equal) == \
        (want.fingerprint_equal, want.queries_equal)
    if plan["kind"] in TF.CORRUPTION_KINDS:
        assert got.raised is not None and not trecovered
        return
    assert got.recovered and got.fingerprint_equal and got.queries_equal
    assert trec.engine_fingerprint(trecovered[0]) == \
        jrec.engine_fingerprint(jrecovered[0])
    assert TF.query_results(trecovered[0]) == \
        JF.query_results(jrecovered[0])


def test_crash_plans_actually_crash(tmp_path):
    for kind in TF.CRASH_KINDS:
        assert TF.run_plan(TF.FaultPlan(kind=kind, seed=3), str(tmp_path),
                           device="cpu").crashed


def test_drop_journal_tail_loses_acked_batches(tmp_path):
    res = TF.run_plan(TF.FaultPlan(kind="drop_journal_tail", seed=1),
                      str(tmp_path), device="cpu")
    assert res.raised is not None and "watermark" in res.raised


def test_plan_validation_and_inputs():
    with pytest.raises(ValueError, match="unknown fault kind"):
        TF.FaultPlan(kind="meteor_strike")
    with pytest.raises(ValueError):
        TF.FaultPlan(kind="crash_after_batch", snapshot_at=0)
    assert TF.KINDS == JF.KINDS
    for seed in (0, 4):
        for a, b in zip(TF.make_batches(TF.FaultPlan("truncate_archive",
                                                     seed=seed)),
                        JF.make_batches(JF.FaultPlan("truncate_archive",
                                                     seed=seed))):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown crash kind"):
        with TF.crash_site("crash_in_space"):
            pass


def test_run_plan_catches_contract_violation(tmp_path, monkeypatch):
    monkeypatch.setattr(TF, "query_results", lambda eng: id(eng))
    with pytest.raises(AssertionError, match="differently"):
        TF.run_plan(TF.FaultPlan(kind="crash_after_batch", seed=3),
                    str(tmp_path), device="cpu")


def test_crash_sites_bite_the_port_modules():
    """The patch lands where the port calls: ``segments`` reaches
    ``release_slices`` through the ``slicepool`` module and calls
    ``_merge_csr`` as its own module global."""
    from repro_torch.core import segments, slicepool
    real = (slicepool.release_slices, segments._merge_csr)
    with TF.crash_site("crash_mid_rollover"):
        with pytest.raises(TF.InjectedCrash):
            slicepool.release_slices(None, None, None)
    with TF.crash_site("crash_mid_compaction"):
        with pytest.raises(TF.InjectedCrash):
            segments.merge_frozen([segments.FrozenSegment(
                offsets=np.zeros(2, np.int64), data=np.zeros(0, np.uint32),
                n_docs=1)])
    assert (slicepool.release_slices, segments._merge_csr) == real


@pytest.mark.parametrize("kind", ["crash_after_batch", "crash_mid_rollover"])
def test_reference_archive_and_journal_recover_in_the_port(tmp_path, kind):
    """A reference engine crashes under the reference harness's crash
    site; its snapshot and journal, recovered by the port, equal the
    reference's recovery of the same files."""
    plan = JF.FaultPlan(kind=kind, seed=4)
    snap, jrnl = str(tmp_path / "s.bin"), str(tmp_path / "j.bin")
    eng = JF.make_engine(plan)
    jrec.snapshot(eng, snap, seq=0)
    acked = 0
    with jrec.IngestJournal(jrnl) as journal:
        for i, docs in enumerate(JF.make_batches(plan)):
            journal.append(docs)
            acked += 1
            try:
                if kind == "crash_mid_rollover" and i >= plan.crash_at:
                    with JF.crash_site(kind):
                        eng.ingest(docs)
                else:
                    eng.ingest(docs)
            except JF.InjectedCrash:
                break
            if i + 1 == plan.snapshot_at:
                jrec.snapshot(eng, snap, seq=i + 1)
            if kind == "crash_after_batch" and i == plan.crash_at:
                break
    assert os.path.getsize(jrnl) > 0 and acked < plan.n_batches + 1
    want = jrec.recover(snap, jrnl, expect_seq=acked)
    got = trec.recover(snap, jrnl, expect_seq=acked, device="cpu",
                       validate=True)
    assert trec.engine_fingerprint(got) == jrec.engine_fingerprint(want)
    assert TF.query_results(got) == JF.query_results(want)
