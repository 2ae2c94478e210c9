"""The search ``ServeLoop`` and the fault plans on real ranks: one shard per
process over ``torch.distributed`` (gloo, CPU), against the stacked
port loop and the reference's loop over its four-device
``ShardedLifecycleEngine``.

* One seeded schedule of submissions, manual-clock advances and steps
  (``DRIVE``) runs through the leader of a world of four gloo ranks
  (``make_rank_mesh(4)``), through the port's loop over
  ``make_doc_mesh(4)`` in this process, and through the reference's loop
  in a subprocess that forces four host devices.  Its buckets are
  flushed full and by the timer, ingest is rejected for a full queue and
  for pool pressure, emergency rollovers happen, and every rung serves.
  The three give the same responses (qid, docids, scores, rung, latency,
  deadline met), the same rejections and the same ``ServeStats``; every
  follower mirrors the leader's stats and its ``check_serve`` is ok.  A
  follower's clock raises if called, and is never called; ``submit_*``,
  ``step``, ``snapshot_now`` and ``drain`` on a follower raise.
* The pool gauge on ranks whose shards sit at different fills is the max
  over the ranks on every rank (a rank's own state gives each rank
  another value), and the leader rejects an ingest batch for pool
  pressure that its own shard alone would admit.
* Under the ranked loop a snapshot, then a crash inside a rollover on
  every rank, then ``recover(mesh=)`` and ``resume_with`` end on the
  uncrashed engine's fingerprint, with the queued batches counted
  ``ingest_recovered``; the loop then serves on.
* ``run_plan`` of every ``FaultPlan`` kind on the four ranks gives the
  stacked run's result and recovered fingerprint, and for the reference
  test's three kinds the reference's four-device fingerprint.
* ``RankMesh.broadcast`` over a (2, 2) mesh whose rules map ``docs`` to
  both dims brings shard 0's object to every rank.

The world and the reference's two subprocesses (the schedule, the
plans) start together and each has its own timeout, so a hang fails its
tests instead of the suite.
"""
import dataclasses
import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.analysis import faults as TF
from repro_torch.analysis import invariants as tinv
from repro_torch.core import lifecycle as tl
from repro_torch.core import pointers as tp
from repro_torch.core import recovery as trec
from repro_torch.core import serve as tsv
from repro_torch.core.sharded_index import make_doc_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 300
RANKS = 4
REFERENCE_PLANS = ("crash_after_batch", "crash_mid_rollover",
                   "drop_journal_tail")

# The schedule, the engines' sizes (the reference's sharded serving
# test's: four shards of pools (64, 24, 6, 2), vocabulary 128, emergency
# rollovers at 0.6) and the plain-list form of a loop's output; the same
# text runs in the ranks, in the reference's subprocess and here.
DRIVE = textwrap.dedent("""
    import dataclasses
    import numpy as np

    V, STEPS, SPP = 128, 30, (64, 24, 6, 2)
    CFG = dict(max_batch=4, query_queue_cap=12, ingest_queue_cap=3,
               deadline_s=0.03, default_k=8, ingest_reject_util=0.66)
    QUERIES = [("conjunctive", (1, 32)), ("conjunctive", (5, 33)),
               ("topk", (9, 34)), ("topk", (33,)),
               ("disjunctive", (2, 35, 9)), ("phrase", (12, 35)),
               ("scored", (1, 32)), ("scored", (6, 33))]

    def arrivals(n):
        # doc d holds terms d % 32 and 32 + (d // 4) % 4, in that order
        ids = np.arange(64 * n)
        docs = np.stack([ids % 32, 32 + (ids // 4) % 4], 1)
        return [docs[i: i + 64] for i in range(0, 64 * n, 64)]

    class Clock:
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            return self.t

    def stats_of(loop):
        return dict(dataclasses.asdict(loop.stats),
                    pending_queries=loop.pending_queries,
                    in_flight_queries=loop.in_flight_queries,
                    pending_ingest=loop.pending_ingest,
                    applied_seq=loop.applied_seq)

    def plain(r):
        return [r.qid, r.kind, [int(x) for x in r.docids],
                None if r.scores is None else [int(x) for x in r.scores],
                r.level, r.level_name, bool(r.degraded), r.latency_s,
                bool(r.deadline_met)]

    def drive(sv, eng, seed=0):
        # (loop, responses, submissions): requests of every kind, one or
        # two arrival batches a step, a random clock advance, and the
        # rung left to the gauge or pinned at random
        clock = Clock()
        loop = sv.ServeLoop(eng, sv.ServeConfig(**CFG), clock=clock)
        rng = np.random.default_rng(seed)
        feed = arrivals(2 * STEPS)
        out, subs = [], []
        for _ in range(STEPS):
            for _ in range(int(rng.integers(0, 7))):
                kind, terms = QUERIES[int(rng.integers(0, len(QUERIES)))]
                r = loop.submit_query(
                    kind, terms, k=int(rng.integers(1, 12)),
                    deadline_s=float(rng.uniform(0.005, 0.05)))
                subs.append(r if isinstance(r, int)
                            else [r.reason, r.retry_after_s])
            for _ in range(int(rng.integers(1, 3))):
                r = loop.submit_ingest(feed[0])
                if isinstance(r, int):
                    feed.pop(0)
                subs.append(r if isinstance(r, int)
                            else [r.reason, r.retry_after_s])
            clock.t += float(rng.uniform(0.0, 0.03))
            loop.force_level = (None if rng.random() < 0.7
                                else int(rng.integers(0, 4)))
            loop.step(force=bool(rng.random() < 0.3))
            out += [plain(r) for r in loop.take_responses()]
        out += [plain(r) for r in loop.drain()]
        return loop, out, subs
""")

REFERENCE = textwrap.dedent("""
    import sys
    from repro.dist import collectives as C
    C.force_host_device_count(4)
    import json
    import os

    from repro.analysis import faults as F
    from repro.core import lifecycle as jl
    from repro.core import pointers as jp
    from repro.core import recovery as jrec
    from repro.core import serve as jsv
    from repro.core.sharded_index import make_doc_mesh
    """) + DRIVE + textwrap.dedent("""
    cfg = json.loads(sys.argv[1])
    mesh, rules = make_doc_mesh(4)
    res = {}
    if cfg["part"] == "serve":
        eng = jl.ShardedLifecycleEngine(
            jp.PoolLayout(z=(1, 4, 7, 11), slices_per_pool=SPP), V,
            100_000, mesh, max_slices=64, max_len=64, rules=rules,
            use_kernel=False,
            admission=jl.AdmissionController(rollover_at=0.6))
        loop, out, subs = drive(jsv, eng)
        res = {"responses": out, "subs": subs, "stats": stats_of(loop)}
    else:
        got, real = [], jrec.recover

        def spy(*a, **k):
            got.append(real(*a, **k))
            return got[-1]
        jrec.recover = spy
        for kind in cfg["plans"]:
            wd = os.path.join(cfg["out"], "reference", kind)
            os.makedirs(wd)
            r = F.run_plan(F.FaultPlan(kind=kind, seed=13), wd, mesh=mesh,
                           rules=rules)
            res[kind] = dict(
                acked=r.acked, crashed=r.crashed,
                raised=r.raised is not None,
                fp=jrec.engine_fingerprint(got[-1]) if r.recovered
                else None)
    print(json.dumps(res))
""")

WORLD = textwrap.dedent("""
    import json, os, pickle, sys
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.analysis import faults as TF
    from repro_torch.analysis import invariants as tinv
    from repro_torch.core import lifecycle as tl
    from repro_torch.core import pointers as tp
    from repro_torch.core import recovery as trec
    from repro_torch.core import serve as tsv
    from repro_torch.core import slicepool
    from repro_torch.core.sharded_index import make_rank_mesh
    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import Rules
    """) + DRIVE + textwrap.dedent("""
    rank, port, cfg = int(sys.argv[1]), int(sys.argv[2]), json.loads(
        sys.argv[3])
    LAYOUT = tp.PoolLayout(z=(1, 4, 7, 11), slices_per_pool=SPP)

    def engine(mesh, docs_per_segment=100_000, **kw):
        return tl.ShardedLifecycleEngine(
            LAYOUT, V, docs_per_segment, mesh, max_slices=64, max_len=64,
            use_kernel=False, device="cpu", **kw)

    def raises(fn):
        try:
            fn()
        except Exception as exc:
            return [type(exc).__name__, str(exc)]
        return None

    class Boom:
        # a follower's clock: any call fails the rank, and so the world
        calls = 0

        def __call__(self):
            Boom.calls += 1
            raise AssertionError("a follower read its clock")

    def report(loop):
        rep = tinv.check_serve(loop)
        return [rep.ok, rep.render()]

    res = {}
    with C.process_world("gloo", rank=rank, world_size=cfg["world"],
                         port=port, timeout_s=cfg["timeout"]):
        mesh = make_rank_mesh(cfg["world"], device="cpu")
        res["shard"] = mesh.shard
        res["broadcast"] = mesh.broadcast(
            {"from": mesh.shard} if mesh.leads else None)
        grid = init_device_mesh("cpu", (2, 2), mesh_dim_names=("a", "b"))
        m22 = make_rank_mesh(rules=Rules(grid, {"docs": ("a", "b")}),
                             device="cpu")
        res["broadcast22"] = m22.broadcast(
            ["shard", m22.shard] if m22.leads else None)

        # (a), (b), (d), (e): the schedule, led by shard 0's rank
        eng = engine(mesh, admission=tl.AdmissionController(
            rollover_at=0.6))
        if mesh.leads:
            loop, res["responses"], res["subs"] = drive(tsv, eng)
            loop.stop()
        else:
            loop = tsv.ServeLoop(eng, tsv.ServeConfig(**CFG), clock=Boom())
            res["refused"] = {
                name: raises(fn) for name, fn in (
                    ("submit_query", lambda: loop.submit_query(
                        "conjunctive", (1, 32))),
                    ("submit_ingest", lambda: loop.submit_ingest(
                        arrivals(1)[0])),
                    ("step", loop.step),
                    ("snapshot_now", lambda: loop.snapshot_now("x")),
                    ("drain", loop.drain))}
            loop.follow()
        res["stats"] = stats_of(loop)
        res["check_serve"] = report(loop)
        res["clock_calls"] = Boom.calls
        res["rollovers"] = eng.stats.rollovers
        del loop, eng

        # the pool gauge with shards at different fills: shard 0's docs
        # hold one term, the others' three
        eng = engine(mesh)
        docs = np.full((64, 3), -1, np.int64)
        for d in range(64):
            n = 1 if d % 4 == 0 else 3
            docs[d, :n] = (np.arange(n) * 13 + d) % V
        eng.ingest(docs)
        own = slicepool.pool_utilization(LAYOUT, eng.segments.active.state)
        top = mesh.combine(own, "max")
        loop = tsv.ServeLoop(eng, tsv.ServeConfig(ingest_reject_util=top,
                                                  degrade_at=(top, 2, 3)))
        res["gauge"] = dict(
            own=own, pool=loop.pressure_components()["pool"],
            level=loop.degradation_level(),
            rejects=loop.pressure_components()["pool"]
            >= loop.config.ingest_reject_util)
        if mesh.leads:
            r = loop.submit_ingest(docs)
            res["gauge"]["verdict"] = (r if isinstance(r, int)
                                       else [r.reason, r.retry_after_s])
        del loop, eng

        # (f): snapshot under serve, a crash inside a rollover on every
        # rank, recover(mesh=) and resume_with
        wal, snap = cfg["out"] + "/serve.jrnl", cfg["out"] + "/serve.snap"
        feed = arrivals(24)
        eng = engine(mesh, docs_per_segment=256)
        clock = Clock()
        loop = tsv.ServeLoop(
            eng, journal=trec.IngestJournal(wal) if mesh.leads else None,
            clock=clock if mesh.leads else Boom())
        if mesh.leads:
            for i in range(3):
                loop.submit_ingest(feed.pop(0))
                loop.submit_query("conjunctive", (1, 32))
                loop.step(force=True)
                if i == 1:
                    loop.snapshot_now(snap)
            loop.stop()
        else:
            loop.follow()
        try:
            with TF.crash_site("crash_mid_rollover"):
                if mesh.leads:
                    while True:
                        for _ in range(2):
                            loop.submit_ingest(feed.pop(0))
                        loop.submit_query("topk", (5, 33), k=3)
                        loop.step(force=True)
                else:
                    loop.follow()
        except TF.InjectedCrash:
            res["crashed"] = True
        res["at_crash"] = stats_of(loop)
        acked = mesh.broadcast(loop.journal.next_seq if mesh.leads
                               else None)
        if mesh.leads:
            loop.journal.close()
        got = trec.recover(snap, wal, mesh=mesh, expect_seq=acked,
                           device="cpu")
        loop.resume_with(got, journal=trec.IngestJournal(wal)
                         if mesh.leads else None)
        res["resumed"] = stats_of(loop)
        res["acked"] = acked
        oracle = engine(mesh, docs_per_segment=256)
        for _, docs in trec.read_journal(wal)[1]:
            oracle.ingest(docs)
        fa = trec.engine_fingerprint(loop.engine)
        fb = trec.engine_fingerprint(oracle)
        fa.pop("stats"), fb.pop("stats")
        res["fp_recovered"], res["fp_uncrashed"] = fa, fb
        if mesh.leads:
            loop.submit_ingest(feed.pop(0))
            loop.submit_query("conjunctive", (1, 32))
            res["after"] = [plain(r) for r in loop.drain()]
            loop.journal.close()
            loop.stop()
        else:
            loop.follow()
        res["final"] = stats_of(loop)
        res["check_serve_final"] = report(loop)
        del loop, got, oracle, eng

        # (g): every fault plan on the ranks, the recovered engine kept
        kept, real = [], trec.recover

        def spy(*a, **k):
            kept.append(real(*a, **k))
            return kept[-1]
        trec.recover = spy
        res["plans"] = {}
        for kind in TF.KINDS:
            wd = os.path.join(cfg["out"], "plans", kind)
            if mesh.leads:
                os.makedirs(wd)
            mesh.combine(0)
            kept.clear()
            r = TF.run_plan(TF.FaultPlan(kind=kind, seed=13), wd,
                            mesh=mesh, device="cpu")
            res["plans"][kind] = dict(
                acked=r.acked, crashed=r.crashed, raised=r.raised is not None,
                fingerprint_equal=r.fingerprint_equal,
                queries_equal=r.queries_equal,
                fp=trec.engine_fingerprint(kept[-1]) if r.recovered
                else None)
    with open(f"{cfg['out']}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
""")

exec(DRIVE)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _communicate(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORLD_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return outs


def _json(x):
    """As JSON gives it back (tuples become lists)."""
    return json.loads(json.dumps(x))


def _stacked_engine(docs_per_segment=100_000, **kw):
    return tl.ShardedLifecycleEngine(
        tp.PoolLayout(z=(1, 4, 7, 11), slices_per_pool=SPP), V,
        docs_per_segment, make_doc_mesh(4, device="cpu"), max_slices=64,
        max_len=64, use_kernel=False, device="cpu", **kw)


def _stacked_plans(tmp):
    """Every plan on the stacked mesh, with its recovered fingerprint."""
    kept, real = [], trec.recover

    def spy(*a, **k):
        kept.append(real(*a, **k))
        return kept[-1]
    out = {}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(trec, "recover", spy)
        for kind in TF.KINDS:
            wd = os.path.join(tmp, "stacked", kind)
            os.makedirs(wd)
            kept.clear()
            r = TF.run_plan(TF.FaultPlan(kind=kind, seed=13), wd,
                            mesh=make_doc_mesh(4, device="cpu"),
                            device="cpu")
            out[kind] = dict(
                acked=r.acked, crashed=r.crashed, raised=r.raised is not None,
                fingerprint_equal=r.fingerprint_equal,
                queries_equal=r.queries_equal,
                fp=trec.engine_fingerprint(kept[-1]) if r.recovered
                else None)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the world of four ranks, started
    together; the stacked loop and plans run here meanwhile."""
    out = str(tmp_path_factory.mktemp("rank_serve"))
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    refs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE,
         json.dumps(dict(part=part, out=out, plans=REFERENCE_PLANS))],
        cwd=ROOT, env=dict(env, JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in ("serve", "plans")]
    port = str(_free_port())
    cfg = json.dumps(dict(world=RANKS, timeout=WORLD_TIMEOUT // 2, out=out))
    world = [subprocess.Popen(
        [sys.executable, "-c", WORLD, str(r), port, cfg], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(RANKS)]
    try:
        loop, responses, subs = drive(tsv, _stacked_engine(
            admission=tl.AdmissionController(rollover_at=0.6)))
        stacked = dict(loop=loop, responses=responses, subs=subs,
                       stats=stats_of(loop))
        stacked["plans"] = _stacked_plans(out)
    finally:
        ref_outs = _communicate(refs)
        _communicate(world)
    ranks = []
    for r in range(RANKS):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    reference, plans = (json.loads(o.strip().splitlines()[-1])
                        for o, _ in ref_outs)
    return dict(stacked=stacked, ranks=ranks, out=out,
                reference=dict(reference, plans=plans))


def test_the_schedule_reaches_every_flush_rung_and_rejection(runs):
    st = runs["stacked"]["stats"]
    assert st["flushes_full"] > 0 and st["flushes_timer"] > 0
    assert all(n > 0 for n in st["served_by_level"]), st["served_by_level"]
    reasons = {s[0] for s in runs["stacked"]["subs"] if isinstance(s, list)}
    assert reasons == {"ingest_queue_full", "pool_pressure"}
    assert all(s[1] > 0 for s in runs["stacked"]["subs"]
               if isinstance(s, list))
    eng = runs["stacked"]["loop"].engine
    assert eng.stats.emergency_rollovers >= 3
    assert runs["ranks"][0]["rollovers"] == eng.stats.rollovers
    assert any(r[2] for r in runs["stacked"]["responses"])


def test_leader_serves_as_the_stacked_loop(runs):
    leader = runs["ranks"][0]
    assert leader["shard"] == 0
    assert leader["responses"] == runs["stacked"]["responses"]
    assert leader["subs"] == runs["stacked"]["subs"]


@pytest.mark.parametrize("rank", range(RANKS))
def test_every_rank_holds_the_stacked_stats_and_check_serve_ok(runs, rank):
    r = runs["ranks"][rank]
    assert r["shard"] == rank
    assert r["stats"] == runs["stacked"]["stats"]
    assert r["check_serve"][0], r["check_serve"][1]
    assert tinv.check_serve(runs["stacked"]["loop"]).ok


def test_reference_loop_on_four_devices_serves_the_same(runs):
    ref = runs["reference"]
    assert ref["responses"] == _json(runs["stacked"]["responses"])
    assert ref["subs"] == _json(runs["stacked"]["subs"])
    assert ref["stats"] == _json(runs["stacked"]["stats"])
    assert ref["responses"] == _json(runs["ranks"][0]["responses"])


def test_followers_never_read_their_clock(runs):
    for r in runs["ranks"][1:]:
        assert r["clock_calls"] == 0


@pytest.mark.parametrize("call", ["submit_query", "submit_ingest", "step",
                                  "snapshot_now", "drain"])
def test_a_follower_refuses_what_the_leader_does(runs, call):
    for r in runs["ranks"][1:]:
        name, msg = r["refused"][call]
        assert name == "RuntimeError" and "leader" in msg, (call, msg)


def test_the_pool_gauge_is_the_max_over_the_ranks(runs):
    """Shards at different fills: a rank's own state differs by rank
    (what each rank read before the gauge was reduced), but the gauge,
    the rung and the ingest verdict are the max over the ranks on every
    rank, and the leader refuses a batch its own shard would admit."""
    gauges = [r["gauge"] for r in runs["ranks"]]
    own = [g["own"] for g in gauges]
    assert len(set(own)) > 1 and own[0] < max(own)
    for g in gauges:
        assert (g["pool"], g["level"], g["rejects"]) == (max(own), 1, True)
    assert gauges[0]["verdict"][0] == "pool_pressure"
    assert gauges[0]["verdict"][1] > 0


def test_crash_under_ranked_serve_recovers_on_every_rank(runs):
    leader = runs["ranks"][0]
    assert leader["at_crash"]["in_flight_queries"] > 0
    assert leader["at_crash"]["pending_ingest"] >= 2
    for r in runs["ranks"]:
        assert r["crashed"]
        assert r["fp_recovered"] == r["fp_uncrashed"] == \
            leader["fp_uncrashed"]
        assert r["resumed"] == leader["resumed"]
        assert r["resumed"]["ingest_recovered"] == \
            leader["at_crash"]["pending_ingest"]
        assert r["resumed"]["queries_aborted"] == \
            leader["at_crash"]["in_flight_queries"]
        assert r["resumed"]["recoveries"] == 1
        assert r["resumed"]["applied_seq"] == leader["acked"]
        assert r["final"] == leader["final"]
        assert r["check_serve_final"][0], r["check_serve_final"][1]
    assert leader["after"] and leader["final"]["pending_ingest"] == 0
    # the stacked engine fed the batches acked by the crash ends on the
    # same state
    oracle = _stacked_engine(docs_per_segment=256)
    for _, docs in trec.read_journal(
            os.path.join(runs["out"], "serve.jrnl"))[1][: leader["acked"]]:
        oracle.ingest(docs)
    fp = trec.engine_fingerprint(oracle)
    fp.pop("stats")
    assert leader["fp_uncrashed"] == fp


@pytest.mark.parametrize("kind", TF.KINDS)
def test_fault_plan_on_four_ranks_as_on_the_stacked_mesh(runs, kind):
    want = runs["stacked"]["plans"][kind]
    if kind in TF.CRASH_KINDS:
        assert want["crashed"] and not want["raised"]
        assert want["fingerprint_equal"] and want["queries_equal"]
    else:
        assert want["raised"] and want["fp"] is None
    for r in runs["ranks"]:
        assert r["plans"][kind] == want, r["shard"]


@pytest.mark.parametrize("kind", REFERENCE_PLANS)
def test_fault_plan_on_four_ranks_as_the_reference(runs, kind):
    ref = runs["reference"]["plans"][kind]
    got = runs["ranks"][0]["plans"][kind]
    assert (got["acked"], got["crashed"], got["raised"]) == \
        (ref["acked"], ref["crashed"], ref["raised"])
    assert _json(got["fp"]) == ref["fp"]


def test_broadcast_brings_shard_0s_object_to_every_rank(runs):
    for r in runs["ranks"]:
        assert r["broadcast"] == {"from": 0}
        assert r["broadcast22"] == ["shard", 0]


def test_on_one_process_the_loop_leads_and_the_broadcast_is_identity():
    mesh = make_doc_mesh(4, device="cpu")
    obj = {"plan": [1, 2]}
    assert mesh.leads and mesh.broadcast(obj) is obj
    loop = tsv.ServeLoop(_stacked_engine(), clock=Clock())
    assert loop.leads
    with pytest.raises(RuntimeError, match="follow"):
        loop.follow()
    loop.stop()                    # releases no one: nothing happens
    loop.submit_query("conjunctive", (1, 32))
    assert loop.step(force=True) == 1
    assert tinv.check_serve(loop).ok
