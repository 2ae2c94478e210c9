"""Port vs reference: sharded archives, sharded recovery and every
sharded fault plan.

* S = 1 in process: the JAX ``ShardedLifecycleEngine`` on
  ``make_doc_mesh(1)`` and the port's, fed the same stream, write
  byte-identical archives with equal fingerprints, and each package
  restores the other's.
* S = 4 in ONE subprocess that forces four host devices (as
  ``tests/test_recovery.py`` does): the JAX side writes an archive and
  its fingerprint; the port restores it with an equal fingerprint, and
  the port's own archive of the same stream has the same bytes.
* A sharded archive refuses a mesh of another shard count, a truncated
  one raises ``CorruptSnapshotError``, and every ``FaultPlan`` kind
  passes its contract on a four-shard port engine.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.core import lifecycle as jl
from repro.core import pointers as jp
from repro.core import recovery as jrec
from repro.core import segments as jseg
from repro.core import sharded_index as jsh
from repro.data import synth
from repro_torch.analysis import faults as TF
from repro_torch.core import lifecycle as tl
from repro_torch.core import pointers as tp
from repro_torch.core import recovery as trec
from repro_torch.core import segments as tseg
from repro_torch.core.sharded_index import make_doc_mesh

Z, SPP = (1, 4, 7, 11), (4096, 2048, 512, 64)
VOCAB, N_DOCS, SEG, BATCH = 300, 480, 128, 32
KW = dict(max_slices=40, max_len=128, max_query_len=4, use_kernel=False)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batches():
    docs = synth.zipf_corpus(synth.CorpusSpec(vocab=VOCAB, n_docs=N_DOCS,
                                              seed=31))
    return [docs[i: i + BATCH] for i in range(0, N_DOCS, BATCH)]


def port_engine(S):
    return tl.ShardedLifecycleEngine(
        tp.PoolLayout(z=Z, slices_per_pool=SPP), VOCAB, SEG,
        make_doc_mesh(S, device="cpu"),
        compaction=tseg.CompactionPolicy(fanout=2),
        admission=tl.AdmissionController(rollover_at=0.97), device="cpu",
        **KW)


def feed(eng, batches):
    for b in batches:
        eng.ingest(b)
    return eng


def _json_fp(fp):
    """A fingerprint as JSON gives it back (tuples become lists)."""
    return json.loads(json.dumps(fp))


def test_one_shard_archives_byte_identical_across_packages(tmp_path):
    batches = _batches()
    mesh, rules = jsh.make_doc_mesh(1)
    j = feed(jl.ShardedLifecycleEngine(
        jp.PoolLayout(z=Z, slices_per_pool=SPP), VOCAB, SEG, mesh,
        rules=rules, compaction=jseg.CompactionPolicy(fanout=2),
        admission=jl.AdmissionController(rollover_at=0.97), **KW), batches)
    t = feed(port_engine(1), batches)
    assert t.stats.rollovers >= 3 and t.stats.compactions >= 1
    assert trec.engine_fingerprint(t) == jrec.engine_fingerprint(j)
    jpath, tpath = str(tmp_path / "j.snap"), str(tmp_path / "t.snap")
    assert trec.snapshot(t, tpath, seq=7) == jrec.snapshot(j, jpath, seq=7)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    back = trec.restore(jpath, device="cpu")
    assert isinstance(back, tl.ShardedLifecycleEngine)
    assert trec.engine_fingerprint(back) == trec.engine_fingerprint(t)
    assert jrec.engine_fingerprint(jrec.restore(tpath, mesh=mesh,
                                                rules=rules)) == \
        jrec.engine_fingerprint(j)
    qs = [(3, 5), (1,), (2, 9, 4)]
    for name in ("conjunctive_batch", "disjunctive_batch"):
        for a, b in zip(getattr(back, name)(qs), getattr(t, name)(qs)):
            np.testing.assert_array_equal(a, b)


SCRIPT_FOUR_SHARDS = textwrap.dedent("""
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
    from repro.data import synth

    path, Z, SPP, VOCAB, N, SEG, B, KW = json.loads(sys.argv[1])
    docs = synth.zipf_corpus(synth.CorpusSpec(vocab=VOCAB, n_docs=N,
                                              seed=31))
    mesh, rules = make_doc_mesh(4)
    eng = jl.ShardedLifecycleEngine(
        jp.PoolLayout(z=tuple(Z), slices_per_pool=tuple(SPP)), VOCAB, SEG,
        mesh, rules=rules, compaction=jseg.CompactionPolicy(fanout=2),
        admission=jl.AdmissionController(rollover_at=0.97), **KW)
    for i in range(0, N, B):
        eng.ingest(docs[i: i + B])
    jrec.snapshot(eng, path, seq=N // B)
    print(json.dumps(jrec.engine_fingerprint(eng)))
""")


def test_four_shard_reference_archive_restores_in_the_port(tmp_path):
    jpath, tpath = str(tmp_path / "j4.snap"), str(tmp_path / "t4.snap")
    args = json.dumps([jpath, Z, SPP, VOCAB, N_DOCS, SEG, BATCH, KW])
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", SCRIPT_FOUR_SHARDS, args],
                         env=env, capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    jfp = json.loads(out.stdout.strip().splitlines()[-1])
    back = trec.restore(jpath, device="cpu")
    assert back.segments.num_shards == 4
    assert _json_fp(trec.engine_fingerprint(back)) == jfp
    t = feed(port_engine(4), _batches())
    assert t.stats.rollovers >= 3 and t.stats.compactions >= 1
    assert _json_fp(trec.engine_fingerprint(t)) == jfp
    trec.snapshot(t, tpath, seq=N_DOCS // BATCH)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    # shard-count refusal, auto mesh, truncation
    with pytest.raises(ValueError, match="shard"):
        trec.restore(tpath, mesh=make_doc_mesh(2, device="cpu"),
                     device="cpu")
    with open(tpath, "rb") as f:
        blob = f.read()
    cut = str(tmp_path / "cut.snap")
    with open(cut, "wb") as f:
        f.write(blob[: len(blob) * 2 // 5])
    with pytest.raises(trec.CorruptSnapshotError):
        trec.restore(cut, device="cpu")
    # both keep computing the same thing after the crossing
    more = _batches()[:3]
    feed(back, more)
    feed(t, more)
    assert trec.engine_fingerprint(back) == trec.engine_fingerprint(t)


@pytest.mark.parametrize("kind", TF.KINDS)
def test_every_fault_plan_on_four_shards(kind, tmp_path):
    plan = TF.FaultPlan(kind=kind, seed=13)
    res = TF.run_plan(plan, str(tmp_path),
                      mesh=make_doc_mesh(4, device="cpu"), device="cpu")
    if kind in TF.CRASH_KINDS:
        assert res.crashed and res.recovered
        assert res.fingerprint_equal and res.queries_equal
    else:
        assert not res.recovered
    eng = TF.make_engine(plan, make_doc_mesh(4, device="cpu"), device="cpu")
    assert isinstance(eng, tl.ShardedLifecycleEngine)
