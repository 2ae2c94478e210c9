"""Port vs reference: the scored-retrieval slice.

* Scored planes (``pack_scored``, ``stack_scored``, ``repad_scored``,
  ``decode_scores``) are byte-identical to the JAX package's.
* The plain ``scored_intersect_batched_ref`` equals the JAX oracle and
  the JAX Pallas kernel run in interpret mode, at thresholds that skip
  no block, about half the blocks and every block, with varied ``rest``.
* ``merge_desc_scored``, ``rank_scored`` and ``finalize_scored`` equal
  the reference on inputs full of tied scores.
* A JAX and a port ``LifecycleEngine`` take one stream through >= 3
  rollovers with compaction; ``scored_topk_batch`` and
  ``scored_full_batch`` return the same ids, scores and block-skip
  counters on every route (batched, the kernel route — which runs the
  plain version on the CPU — ``batched=False`` and ``frozen_only``).

Everything is integer: the tolerance is zero.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lifecycle as jl
from repro.core import pointers as jp
from repro.core import qexec as jq
from repro.core import segments as jseg
from repro.core import sharded_index as jsh
from repro.data import synth
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import segment_intersect as jsi
from repro_torch.core import lifecycle as tl
from repro_torch.core import pointers as tp
from repro_torch.core import qexec as tq
from repro_torch.core import segments as tseg
from repro_torch.core import sharded_index as tsh
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segment_intersect as tsi

from conftest import max_slices_for

INVALID = 0xFFFFFFFF
SIZES = [0, 1, 90, 128, 129, 300, 700]


def _scored_lists(seed, sizes=SIZES, span=1 << 12):
    """Ascending docids with impacts capped per 128-lane block, so block
    maxima differ and a threshold can split the blocks."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        ids = np.sort(rng.choice(span, n, replace=False)).astype(np.uint32)
        caps = rng.integers(1, 256, -(-n // 128) or 1)
        sc = rng.integers(1, caps[np.arange(n) // 128] + 1).astype(np.int32)
        out.append((ids, sc))
    return out


def _np(x):
    return np.asarray(x)


def _jstack(s):
    ids = jsi.StackedLists(*[jnp.asarray(getattr(s.ids, f))
                             for f in jsi.StackedLists._fields])
    return jsi.ScoredStack(ids=ids, swords=jnp.asarray(s.swords),
                           bmax=jnp.asarray(s.bmax))


@pytest.mark.parametrize("seed", [0, 1])
def test_scored_planes_byte_identical(seed):
    lists = _scored_lists(seed)
    js, ts = [], []
    for ids, sc in lists:
        j, t = jsi.pack_scored(ids, sc), tsi.pack_scored(ids, sc)
        assert j.smax == t.smax and j.ids.n == t.ids.n
        for f in ("firsts", "bws", "woffs", "payload"):
            a, b = _np(getattr(j.ids, f)), getattr(t.ids, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        for f in ("swords", "bmax"):
            a, b = _np(getattr(j, f)), getattr(t, f)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
        js.append(j)
        ts.append(t)
    jst, tst = jsi.stack_scored(js), tsi.stack_scored(ts)
    nb, pw = jst.ids.n_blocks * 2, jst.ids.n_words * 4
    for jx, tx in ((jst, tst), (jsi.repad_scored(jst, nb, pw),
                                tsi.repad_scored(tst, nb, pw))):
        for f in jsi.StackedLists._fields:
            np.testing.assert_array_equal(getattr(tx.ids, f),
                                          getattr(jx.ids, f))
        for f in ("swords", "bmax"):
            a, b = _np(getattr(jx, f)), getattr(tx, f)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
        got = tsi.decode_scores(torch.as_tensor(
            tx.swords.astype(np.int64))).numpy()
        np.testing.assert_array_equal(
            got, _np(jsi.decode_scores(jnp.asarray(jx.swords))))
    with pytest.raises(ValueError):
        tsi.attach_scores(tsi.pack_docids(lists[2][0]),
                          np.zeros(lists[2][0].size, np.int32))


def _thresholds(a_st, rest, mode):
    """th per row: -1 (no skip), the median block bound of the row's real
    blocks (about half skip), or above every bound (all skip)."""
    bound = a_st.bmax.astype(np.int64) + rest[:, None]
    nblk = -(-a_st.ids.ns // 128)
    th = np.full(rest.shape, -1, np.int64)
    for r, k in enumerate(nblk):
        if mode == "mid" and k:
            th[r] = int(np.median(bound[r, :k]))
        elif mode == "above":
            th[r] = int(bound[r].max()) + 1
    return th.astype(np.int32)


@pytest.mark.parametrize("mode", ["none", "mid", "above"])
def test_scored_kernel_plain_version_matches_reference(mode):
    a_l = _scored_lists(3)
    b_l = _scored_lists(4)[::-1]          # pairs every size with another
    A = jsi.stack_scored([jsi.pack_scored(i, s) for i, s in a_l])
    B = jsi.stack_scored([jsi.pack_scored(i, s) for i, s in b_l])
    TA = tsi.stack_scored([tsi.pack_scored(i, s) for i, s in a_l])
    TB = tsi.stack_scored([tsi.pack_scored(i, s) for i, s in b_l])
    rest = np.random.default_rng(5).integers(0, 300, len(a_l)).astype(
        np.int32)
    th = _thresholds(A, rest, mode)
    jA, jB = _jstack(A), _jstack(B)
    want = _np(jref.scored_intersect_batched_ref(
        jA, jB, jnp.asarray(rest), jnp.asarray(th)))
    pallas = _np(jops.scored_intersect_batched(
        jA, jB, jnp.asarray(rest), jnp.asarray(th), use_kernel=True,
        interpret=True))
    np.testing.assert_array_equal(pallas, want)
    args = (TA.to("cpu"), TB.to("cpu"), torch.as_tensor(rest),
            torch.as_tensor(th))
    got = tref.scored_intersect_batched_ref(*args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ops.scored_intersect_batched(*args)
                                  .numpy(), want)
    hits = (want > 0).sum()
    if mode == "above":
        assert hits == 0
    else:
        assert hits > 0
    if mode == "mid":                     # the threshold really splits
        full = _np(jref.scored_intersect_batched_ref(
            jA, jB, jnp.asarray(rest), jnp.full(len(a_l), -1, jnp.int32)))
        assert 0 < hits < (full > 0).sum()


def test_cuda_wrapper_refuses_cpu_tensors():
    a = tsi.stack_scored([tsi.pack_scored(*_scored_lists(0)[3])]).to("cpu")
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tsi.scored_intersect_batched(a, a, z, z)


def _tied(seed, rows=3, width=48):
    """Descending docid rows (INVALID-padded) with scores from a tiny
    range, so most scores tie."""
    rng = np.random.default_rng(seed)
    ids = np.full((rows, width), INVALID, np.uint32)
    sc = np.zeros((rows, width), np.int32)
    ns = []
    for r in range(rows):
        x = np.unique(rng.integers(0, 10_000, rng.integers(0, width)))
        ids[r, : x.size] = x[::-1]
        sc[r, : x.size] = rng.integers(1, 4, x.size)
        ns.append(x.size)
    return ids, sc, np.asarray(ns, np.int32)


def _t64(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def test_merge_desc_scored_matches():
    ids, sc, _ = _tied(1, rows=4, width=32)
    for flat, fsc in ((ids.reshape(-1), sc.reshape(-1)), (ids, sc)):
        if flat.ndim == 1:
            jd, js = jsh.merge_desc_scored(jnp.asarray(flat),
                                           jnp.asarray(fsc))
        else:
            jd, js = zip(*[jsh.merge_desc_scored(jnp.asarray(a),
                                                 jnp.asarray(b))
                           for a, b in zip(flat, fsc)])
        td, ts = tsh.merge_desc_scored(_t64(flat), torch.as_tensor(fsc))
        np.testing.assert_array_equal(td.numpy(),
                                      np.asarray(jd).astype(np.int64))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_rank_and_finalize_scored_match():
    ids, sc, ns = _tied(2)
    n = jnp.asarray(ns)
    for got, want in zip(
            tq.rank_scored(_t64(ids), torch.as_tensor(sc),
                           torch.as_tensor(ns)),
            jq.rank_scored(jnp.asarray(ids), jnp.asarray(sc), n)):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(got.numpy()
                                                              .dtype))
    live = np.asarray([1, 0, 1], np.int32)
    base = 5000
    want = jq.finalize_scored(jnp.asarray(ids), jnp.asarray(sc), n,
                              jnp.asarray(live), jnp.uint32(base))
    got = tq.finalize_scored(_t64(ids), torch.as_tensor(sc),
                             torch.as_tensor(ns), torch.as_tensor(live),
                             base)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).astype(g.numpy().dtype))
    # ties at equal score rank the newer (larger) docid first
    r_ids, r_sc, _ = got
    for row, srow, k in zip(r_ids.numpy(), r_sc.numpy(), ns * live):
        key = list(zip(-srow[:k], -row[:k]))
        assert key == sorted(key)


# ---------------------------------------------------------------------------
# the engine: one stream through both packages
# ---------------------------------------------------------------------------
VOCAB, N_DOCS, SEG, BATCH = 400, 900, 180, 60
KS = [1, 7, 10, 64, 5000]


@pytest.fixture(scope="module")
def engines():
    spec = synth.CorpusSpec(vocab=VOCAB, n_docs=N_DOCS, seed=11)
    docs = synth.zipf_corpus(spec)
    freqs = synth.term_freqs(docs, VOCAB)
    z, spp = (1, 4, 7, 11), (4096, 2048, 512, 64)
    kw = dict(max_slices=max_slices_for(z, freqs),
              max_len=1 << int(freqs.max()).bit_length(), max_query_len=4)
    j = jl.LifecycleEngine(jp.PoolLayout(z=z, slices_per_pool=spp), VOCAB,
                           SEG, compaction=jseg.CompactionPolicy(fanout=2),
                           **kw)
    t = tl.LifecycleEngine(tp.PoolLayout(z=z, slices_per_pool=spp), VOCAB,
                           SEG, compaction=tseg.CompactionPolicy(fanout=2),
                           device="cpu", **kw)
    for i in range(0, N_DOCS, BATCH):
        j.ingest(docs[i: i + BATCH])
        t.ingest(docs[i: i + BATCH])
    assert t.stats.rollovers >= 3 and t.stats.compactions >= 1
    qs = synth.query_log("aol", 7, docs, VOCAB, seed=12)
    queries = [tuple(int(x) for x in r if x >= 0) for r in qs]
    head = [int(x) for x in np.argsort(-freqs)[:3]]
    queries += [(head[0],), (head[0], head[1]), tuple(head)]
    return j, t, queries


def _skip_stats(eng):
    return (eng.stats.scored_blocks_skipped, eng.stats.scored_blocks_live)


def _assert_scored_equal(want, got, ctx):
    assert len(want) == len(got), ctx
    for (wi, ws), (gi, gs) in zip(want, got):
        np.testing.assert_array_equal(gi, wi, err_msg=ctx)
        np.testing.assert_array_equal(gs, ws, err_msg=ctx)
        assert gi.dtype == np.int64 and gs.dtype == np.int64


@pytest.mark.parametrize("route", ["batched", "batched_kernel",
                                   "sequential"])
def test_scored_queries_and_stats_match(engines, route):
    j, t, queries = engines
    t._batched_kernel = route == "batched_kernel"
    t.batched = j.batched = route != "sequential"
    try:
        hits = 0
        for frozen_only in (False, True):
            calls = [("scored_topk_batch", k) for k in KS] + [
                ("scored_full_batch", None), ("scored_full_batch", 5)]
            for name, k in calls:
                j0, t0 = _skip_stats(j), _skip_stats(t)
                want = getattr(j, name)(queries, k, frozen_only)
                got = getattr(t, name)(queries, k, frozen_only)
                ctx = f"{route} {name} k={k} frozen_only={frozen_only}"
                _assert_scored_equal(want, got, ctx)
                dj = np.subtract(_skip_stats(j), j0)
                dt = np.subtract(_skip_stats(t), t0)
                np.testing.assert_array_equal(dt, dj, err_msg=ctx)
                hits += sum(len(i) for i, _ in got)
        assert hits > 0
    finally:
        t.batched = j.batched = True
        t._batched_kernel = False
    if route == "batched":
        assert t.stats.scored_blocks_live > 0
        assert t.stats.scored_blocks_skipped > 0


def test_scored_single_query_api_and_dispatch_match(engines):
    j, t, queries = engines
    q = queries[-1]
    for k in (3, 0):
        _assert_scored_equal([j.scored_topk(q, k)], [t.scored_topk(q, k)],
                             f"scored_topk k={k}")
    _assert_scored_equal([j.scored_full(q)], [t.scored_full(q)],
                         "scored_full")
    for kind, kw in (("scored", dict(k=10)), ("scored_full", {}),
                     ("scored_full", dict(k=4))):
        _assert_scored_equal(j.dispatch(kind, queries, **kw).wait(),
                             t.dispatch(kind, queries, **kw).wait(), kind)
    with pytest.raises(ValueError, match="needs k"):
        t.dispatch("scored", queries)
    assert dataclasses.asdict(j.stats) == dataclasses.asdict(t.stats)


def test_scored_topk_is_full_sort_prefix(engines):
    """Within the port: the block-max walk equals the exhaustive
    evaluation's prefix for every k (the reference's own contract)."""
    _, t, queries = engines
    full = t.scored_full_batch(queries)
    for k in KS:
        got = t.scored_topk_batch(queries, k)
        _assert_scored_equal([(i[:k], s[:k]) for i, s in full], got,
                             f"k={k}")
