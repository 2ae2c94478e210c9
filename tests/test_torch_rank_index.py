"""The document-sharded index on real ranks: one shard per process over
``torch.distributed`` (gloo, CPU), against the stacked port engine and
the reference's ``ShardedLifecycleEngine`` on four host devices.

* A world of four gloo ranks runs ``ShardedLifecycleEngine`` on
  ``make_rank_mesh(4)`` over a stream that rolls over four times with a
  ``CompactionPolicy(fanout=2)`` cascade and admission on.  Rank s's
  shard equals row s of the stacked engine's state, bit for bit (and at
  S = 2 in a world of two).  Every query kind -- conjunctive,
  disjunctive, phrase, top-k at k = 1, 7, 64, scored top-k and
  exhaustive scored -- batched and ``batched=False``, gives on every
  rank the stacked engine's answers and the reference's.
* The same world builds a (2, 2) ``DeviceMesh`` whose rules map
  ``docs`` to both dims (row-major shard id) and gets the same answers
  over the kernel routes (``use_kernel=True``).
* Archives: the ranks' snapshot is byte-identical to the stacked
  engine's and to the reference's; the reference's archive restores
  onto four ranks and the ranks' archive onto the stacked mesh;
  ``recover`` from a mid-stream snapshot taken on the ranks plus a
  journal ends on the uncrashed engine; every fingerprint is equal.
* With ``validate=True`` a shard broken on one rank makes every rank
  raise ``InvariantViolation`` at the next rollover.
* A rank mesh of four in a world of two, a rank mesh on ``cuda`` with no
  card and rules that map ``docs`` to no dim all raise.
* The CRC join the ranks' fingerprint uses equals zlib's CRC32 of the
  joined bytes.

Each world is its own set of processes with its own timeout, so a hang
fails its test instead of the suite; the reference runs in a subprocess
that forces four host devices.
"""
import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import zlib

import numpy as np
import pytest
import torch

from repro.data import synth
from repro_torch.core import lifecycle as tl
from repro_torch.core import pointers as tp
from repro_torch.core import recovery as trec
from repro_torch.core import segments as tseg
from repro_torch.core.sharded_index import make_doc_mesh, make_rank_mesh
from repro_torch.dist import collectives as C

from conftest import max_slices_for

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Z, SPP = (1, 4, 7, 11), (4096, 2048, 512, 64)
VOCAB, N_DOCS, SEG, BATCH, S = 400, 720, 160, 40, 4
MID = 6                   # batches in the mid-stream snapshot
KINDS = ("conjunctive", "disjunctive", "phrase", "topk1", "topk7",
         "topk64", "scored_topk", "scored_full")
LEAVES = ("heap", "watermark", "tail", "freq", "overflow", "free_list",
          "free_count")
WORLD_TIMEOUT = 300

# every query kind, batched and `batched=False`, as plain lists; the
# same text runs in the reference's subprocess, the ranks and here
ANSWERS = textwrap.dedent("""
    def answers(eng, qs, pairs):
        out = {}
        for mode, flag in (("batched", True), ("sequential", False)):
            eng.batched = flag
            r = {"conjunctive": eng.conjunctive_batch(qs),
                 "disjunctive": eng.disjunctive_batch(qs),
                 "phrase": eng.phrase_batch(pairs)}
            for k in (1, 7, 64):
                r[f"topk{k}"] = eng.topk_conjunctive_batch(qs, k)
            r["scored_topk"] = eng.scored_topk_batch(qs, 5)
            r["scored_full"] = eng.scored_full_batch(qs)
            out[mode] = {
                kind: [[[int(x) for x in part] for part in a]
                       if isinstance(a, tuple) else [int(x) for x in a]
                       for a in got]
                for kind, got in r.items()}
        eng.batched = True
        return out
""")
exec(ANSWERS)

REFERENCE = textwrap.dedent("""
    import sys
    from repro.dist import collectives as C
    C.force_host_device_count(4)
    import json
    import numpy as np

    from repro.core import lifecycle as jl
    from repro.core import pointers as jp
    from repro.core import recovery as jrec
    from repro.core import segments as jseg
    from repro.core.sharded_index import make_doc_mesh
    """) + ANSWERS + textwrap.dedent("""
    cfg = json.loads(sys.argv[1])
    docs = np.load(cfg["docs"])
    mesh, rules = make_doc_mesh(4)
    eng = jl.ShardedLifecycleEngine(
        jp.PoolLayout(z=tuple(cfg["z"]), slices_per_pool=tuple(cfg["spp"])),
        cfg["vocab"], cfg["seg"], mesh, rules=rules,
        compaction=jseg.CompactionPolicy(fanout=2),
        admission=jl.AdmissionController(rollover_at=0.97), **cfg["kw"])
    B = cfg["batch"]
    for i in range(0, len(docs), B):
        eng.ingest(docs[i: i + B])
    jrec.snapshot(eng, cfg["ref_archive"], seq=len(docs) // B)
    fp = jrec.engine_fingerprint(eng)
    out = answers(eng, [tuple(q) for q in cfg["queries"]],
                  [tuple(p) for p in cfg["pairs"]])
    print(json.dumps({"fp": fp, "answers": out}))
""")

WORLD = textwrap.dedent("""
    import json, pickle, sys
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.analysis.invariants import InvariantViolation
    from repro_torch.core import lifecycle as tl
    from repro_torch.core import pointers as tp
    from repro_torch.core import recovery as trec
    from repro_torch.core import segments as tseg
    from repro_torch.core.sharded_index import make_rank_mesh
    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import Rules
    """) + ANSWERS + textwrap.dedent("""
    rank, port, cfg = int(sys.argv[1]), int(sys.argv[2]), json.loads(
        sys.argv[3])
    n = cfg["world"]
    docs = np.load(cfg["docs"])
    B = cfg["batch"]
    qs = [tuple(q) for q in cfg["queries"]]
    pairs = [tuple(p) for p in cfg["pairs"]]
    layout = tp.PoolLayout(z=tuple(cfg["z"]), slices_per_pool=tuple(
        cfg["spp"]))

    def engine(mesh, **kw):
        kw = dict(cfg["kw"], **kw)
        return tl.ShardedLifecycleEngine(
            layout, cfg["vocab"], cfg["seg"], mesh,
            compaction=tseg.CompactionPolicy(fanout=2),
            admission=tl.AdmissionController(rollover_at=0.97),
            device="cpu", **kw)

    def feed(eng, batches):
        for i in batches:
            eng.ingest(docs[i * B: (i + 1) * B])
        return eng

    def raises(fn):
        try:
            fn()
        except Exception as exc:
            return [type(exc).__name__, str(exc)]
        return None

    def leaves(eng):
        st = eng.segments.active.state
        return {f: getattr(st, f).numpy().copy() for f in st._fields}

    res = {}
    nb = len(docs) // B
    with C.process_world("gloo", rank=rank, world_size=n, port=port,
                         timeout_s=cfg["timeout"]) as (r, size):
        res["rank"], res["size"] = r, size
        res["small_world"] = raises(lambda: make_rank_mesh(
            2 * n, device="cpu"))
        res["no_docs"] = raises(lambda: make_rank_mesh(rules=Rules(
            init_device_mesh("cpu", (n,), mesh_dim_names=("data",)),
            {"batch": "data"}), device="cpu"))
        mesh = make_rank_mesh(n, device="cpu")
        res["shard"] = mesh.shard
        eng = feed(engine(mesh), range(nb))
        res["leaves"] = leaves(eng)
        res["stats"] = dict(rollovers=eng.stats.rollovers,
                            compactions=eng.stats.compactions)
        res["term_freqs"] = eng.segments.active.term_freqs()
        res["shard_slots"] = eng.segments.active.shard_slots_used()
        res["fp"] = trec.engine_fingerprint(eng)
        if n == 4:
            trec.snapshot(eng, cfg["rank_archive"], seq=nb)
            res["answers"] = answers(eng, qs, pairs)
            # the same stream over a (2, 2) mesh, docs over both dims
            grid = init_device_mesh("cpu", (2, 2), mesh_dim_names=("a", "b"))
            m22 = make_rank_mesh(rules=Rules(grid, {"docs": ("a", "b")}),
                                 device="cpu")
            res["shard22"] = m22.shard
            e22 = feed(engine(m22, use_kernel=True), range(nb))
            res["answers22"] = answers(e22, qs, pairs)
            del e22
            # the reference's archive onto the ranks
            back = trec.restore(cfg["ref_archive"], mesh=mesh, device="cpu")
            res["fp_ref_restored"] = trec.engine_fingerprint(back)
            res["ref_restored_conj"] = [
                a.tolist() for a in back.conjunctive_batch(qs)]
            del back
            # a mid-stream snapshot on the ranks, then recover + journal
            mid = feed(engine(mesh), range(cfg["mid"]))
            trec.snapshot(mid, cfg["mid_archive"], seq=cfg["mid"])
            rec = trec.recover(cfg["mid_archive"], cfg["journal"],
                               mesh=mesh, device="cpu",
                               expect_seq=nb)
            res["fp_recovered"] = trec.engine_fingerprint(rec)
            res["recovered_conj"] = [
                a.tolist() for a in rec.conjunctive_batch(qs)]
            del rec
            # validation: rank 1's shard broken, every rank raises
            mid.validate = True
            if mesh.shard == 1:
                mid.segments.active.state.watermark[0, -1] += 1
            res["validate"] = raises(lambda: feed(
                mid, range(cfg["mid"], cfg["mid"] + 2)))
            res["after_validate"] = mesh.combine(1)
    with open(f"{cfg['out']}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _world(cfg: dict, n: int):
    """``WORLD`` on ``n`` gloo ranks; each rank's results."""
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    port = str(_free_port())
    cfg = dict(cfg, world=n, timeout=WORLD_TIMEOUT // 2,
               out=os.path.join(cfg["out"], f"world{n}"))
    os.makedirs(cfg["out"], exist_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORLD, str(r), port, json.dumps(cfg)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(n)]
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
    res = []
    for r in range(n):
        with open(os.path.join(cfg["out"], f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def _queries(docs):
    freqs = synth.term_freqs(docs, VOCAB)
    top = [int(t) for t in np.argsort(-freqs)]
    queries = [(top[0], top[1]), (top[2], top[5]), (top[9],),
               (top[1], top[3], top[7]), (top[0], VOCAB - 1),
               (top[0], top[2], top[4], top[6]), (top[3], top[4])]
    pairs = [(top[0], top[1]), (top[2], top[0]),
             (int(docs[3, 0]), int(docs[3, 1])),
             (int(docs[100, 1]), int(docs[100, 2]))]
    kw = dict(max_slices=max_slices_for(Z, freqs),
                    max_len=1 << (int(freqs.max()) - 1).bit_length(),
              max_query_len=4, use_kernel=False)
    return queries, pairs, kw


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    d = tmp_path_factory.mktemp("rank_index")
    docs = synth.zipf_corpus(synth.CorpusSpec(vocab=VOCAB, n_docs=N_DOCS,
                                              seed=23))
    np.save(d / "docs.npy", docs)
    queries, pairs, kw = _queries(docs)
    with trec.IngestJournal(str(d / "journal")) as j:
        for i in range(0, N_DOCS, BATCH):
            j.append(docs[i: i + BATCH])
    return dict(docs=str(d / "docs.npy"), z=Z, spp=SPP, vocab=VOCAB,
                seg=SEG, batch=BATCH, kw=kw, queries=queries, pairs=pairs,
                mid=MID, journal=str(d / "journal"), out=str(d),
                ref_archive=str(d / "ref.snap"),
                rank_archive=str(d / "rank.snap"),
                mid_archive=str(d / "mid.snap"),
                stacked_archive=str(d / "stacked.snap"))


@pytest.fixture(scope="module")
def reference(cfg):
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(cfg)],
                         env=env, capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _stacked_engine(cfg, n_shards):
    return tl.ShardedLifecycleEngine(
        tp.PoolLayout(z=Z, slices_per_pool=SPP), VOCAB, SEG,
        make_doc_mesh(n_shards, device="cpu"),
        compaction=tseg.CompactionPolicy(fanout=2),
        admission=tl.AdmissionController(rollover_at=0.97), device="cpu",
        **cfg["kw"])


@pytest.fixture(scope="module")
def stacked(cfg):
    docs = np.load(cfg["docs"])
    out = {}
    for n in (2, 4):
        eng = _stacked_engine(cfg, n)
        for i in range(0, N_DOCS, BATCH):
            eng.ingest(docs[i: i + BATCH])
        out[n] = dict(eng=eng, fp=trec.engine_fingerprint(eng))
    eng = out[4]["eng"]
    trec.snapshot(eng, cfg["stacked_archive"], seq=N_DOCS // BATCH)
    out[4]["answers"] = answers(eng, [tuple(q) for q in cfg["queries"]],
                                [tuple(p) for p in cfg["pairs"]])
    return out


@pytest.fixture(scope="module")
def world4(cfg, reference):
    return _world(cfg, 4)


@pytest.fixture(scope="module")
def world2(cfg):
    return _world(cfg, 2)


def _json(x):
    """As JSON gives it back (tuples become lists)."""
    return json.loads(json.dumps(x))


@pytest.mark.parametrize("n", [2, 4])
def test_each_rank_holds_row_s_of_the_stacked_state(n, stacked, world2,
                                                    world4):
    ranks = world2 if n == 2 else world4
    st = stacked[n]["eng"].segments.active.state
    eng = stacked[n]["eng"]
    assert eng.stats.rollovers == 4 and eng.stats.compactions >= 2
    assert sorted(r["shard"] for r in ranks) == list(range(n))
    for r in ranks:
        assert r["size"] == n and r["shard"] == r["rank"]
        assert r["stats"] == dict(rollovers=eng.stats.rollovers,
                                  compactions=eng.stats.compactions)
        for f in LEAVES:
            got = r["leaves"][f]
            assert got.shape[0] == 1, f
            np.testing.assert_array_equal(
                got[0], getattr(st, f)[r["shard"]].numpy(), err_msg=f)
        np.testing.assert_array_equal(
            r["term_freqs"], eng.segments.active.term_freqs())
        np.testing.assert_array_equal(
            r["shard_slots"], eng.segments.active.shard_slots_used())
        assert r["fp"] == stacked[n]["fp"]


@pytest.mark.parametrize("mode", ["batched", "sequential"])
@pytest.mark.parametrize("kind", KINDS)
def test_every_rank_answers_as_stacked_and_reference(kind, mode, stacked,
                                                     world4, reference):
    want = stacked[4]["answers"][mode][kind]
    assert want == reference["answers"][mode][kind]
    assert any(len(a) for a in want), "a kind with no answers tests nothing"
    for r in world4:
        assert r["answers"][mode][kind] == want, (r["rank"], kind, mode)


def test_two_by_two_mesh_gives_the_same_answers(stacked, world4):
    """docs over both dims of a (2, 2) mesh: the shard id is row-major
    (rank = 2a + b), and the kernel routes give the same bits."""
    assert [r["shard22"] for r in world4] == [0, 1, 2, 3]
    for r in world4:
        assert r["answers22"] == stacked[4]["answers"]


def test_rank_archive_is_byte_identical(cfg, stacked, world4, reference):
    with open(cfg["rank_archive"], "rb") as f:
        ranked = f.read()
    for other in ("stacked_archive", "ref_archive"):
        with open(cfg[other], "rb") as f:
            assert f.read() == ranked, other


def test_reference_archive_restores_on_ranks(stacked, world4, reference):
    want = stacked[4]["answers"]["batched"]["conjunctive"]
    for r in world4:
        assert _json(r["fp_ref_restored"]) == reference["fp"]
        assert r["ref_restored_conj"] == want


def test_rank_archive_restores_on_the_stacked_mesh(cfg, stacked, world4):
    back = trec.restore(cfg["rank_archive"], device="cpu")
    assert back.segments.num_shards == 4
    assert back.segments.mesh.local_shards == (0, 1, 2, 3)
    assert trec.engine_fingerprint(back) == stacked[4]["fp"]
    with pytest.raises(ValueError, match="shard"):
        trec.restore(cfg["rank_archive"],
                     mesh=make_doc_mesh(2, device="cpu"), device="cpu")


def test_recover_on_ranks_ends_on_the_uncrashed_engine(stacked, world4):
    want = stacked[4]["answers"]["batched"]["conjunctive"]
    for r in world4:
        assert r["fp_recovered"] == stacked[4]["fp"]
        assert r["recovered_conj"] == want


def test_fingerprints_equal_across_three_engines(stacked, world4,
                                                 reference):
    assert _json(stacked[4]["fp"]) == reference["fp"]
    for r in world4:
        assert _json(r["fp"]) == reference["fp"]


def test_a_broken_shard_fails_validation_on_every_rank(world4):
    for r in world4:
        assert r["validate"] is not None, r["rank"]
        name, msg = r["validate"]
        assert name == "InvariantViolation", (r["rank"], msg)
        if r["shard"] == 1:
            assert "watermark" in msg and "shard 1" in msg
        else:
            assert "another rank" in msg
        # no rank is left inside a collective: the world goes on
        assert r["after_validate"] == 4


def test_rank_mesh_refuses_a_world_smaller_than_the_mesh(world2):
    for r in world2:
        name, msg = r["small_world"]
        assert name == "RuntimeError" and "need 4 ranks, have 2" in msg


def test_rank_mesh_refuses_cuda_without_a_card(monkeypatch):
    """No card: the rank mesh and an NCCL world raise (no CPU fallback),
    and no process group is left behind."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_rank_mesh(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        with C.process_world("nccl", rank=0, world_size=1, port=1):
            pass
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_rules_without_a_docs_axis_raise(world2):
    for r in world2:
        name, msg = r["no_docs"]
        assert name == "ValueError" and "'docs'" in msg


def test_process_world_takes_its_backend_and_world_from_the_caller():
    for kw, err in (({"backend": "mpi"}, ValueError),
                    ({"backend": "gloo", "rank": 0}, ValueError)):
        with pytest.raises(err):
            with C.process_world(**kw):
                pass
    import torch.distributed as dist
    assert not dist.is_initialized()


@pytest.mark.parametrize("n1,n2", [(0, 5), (5, 0), (1, 1), (100, 37),
                                   (4096, 1 << 20)])
def test_crc32_combine_matches_zlib(n1, n2):
    """The ranks join their rows' CRCs into the fingerprint's: equal to
    zlib's CRC32 of the concatenated bytes."""
    rng = np.random.default_rng(n1 + n2)
    a, b = rng.bytes(n1), rng.bytes(n2)
    assert trec._crc32_combine(zlib.crc32(a), zlib.crc32(b), n2) == \
        zlib.crc32(a + b)
