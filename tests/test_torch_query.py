"""Port vs reference: the active segment's query engine.

The conftest corpus is indexed by the JAX package (``indexed_segment``)
and by the port on the CPU; every engine function — with and without
the ``intersect_mask`` route — and the batched qexec active functions
must return exactly the reference's docids, counts and checksums.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qexec as jq
from repro.core import query as jqry
from repro.data import synth
from repro_torch.core import convert
from repro_torch.core import pointers as tp
from repro_torch.core import qexec as tq
from repro_torch.core import query as tqry
from repro_torch.core.index import ActiveSegment

from conftest import max_slices_for


@pytest.fixture(scope="module")
def both(small_layout, indexed_segment):
    jseg, docs, freqs = indexed_segment
    tl = tp.PoolLayout(z=small_layout.z,
                       slices_per_pool=small_layout.slices_per_pool)
    tseg = ActiveSegment(tl, jseg.vocab_size, device="cpu")
    tseg.ingest(docs)
    ms = max_slices_for(small_layout.z, freqs)
    max_len = 1 << int(freqs.max()).bit_length()
    qs = synth.query_log("aol", 24, docs, jseg.vocab_size, seed=5)
    queries = [[int(t) for t in r if t >= 0] for r in qs]
    return dict(jseg=jseg, tseg=tseg, jl=small_layout, tl=tl, ms=ms,
                max_len=max_len, queries=queries, docs=docs)


def test_ingested_state_matches(both):
    want = {f: np.asarray(getattr(both["jseg"].state, f))
            for f in both["jseg"].state._fields}
    got = convert.pool_state_to_numpy(both["tseg"].state)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_engine_queries_match(both, use_kernel):
    mq = 4
    je = jqry.make_engine(both["jl"], both["ms"], both["max_len"], mq,
                          use_kernel=use_kernel)
    te = tqry.make_engine(both["tl"], both["ms"], both["max_len"], mq,
                          use_kernel=use_kernel)
    js, ts = both["jseg"].state, both["tseg"].state
    for q in both["queries"]:
        terms = np.zeros(mq, np.int64)
        terms[: len(q)] = q
        jt, tt = jnp.asarray(terms, jnp.uint32), torch.as_tensor(terms)
        for kind in ("conjunctive", "disjunctive"):
            jd, jn = getattr(je, kind)(js, jt, jnp.int32(len(q)))
            td, tn = getattr(te, kind)(ts, tt, torch.tensor(len(q)))
            assert int(jn) == int(tn), (kind, q)
            np.testing.assert_array_equal(
                td.numpy()[: int(tn)], np.asarray(jd, np.int64)[: int(jn)])
        jd, jn = je.topk_conjunctive(js, jt, jnp.int32(len(q)), 5)
        td, tn = te.topk_conjunctive(ts, tt, torch.tensor(len(q)), 5)
        assert int(jn) == int(tn)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd, np.int64))
        t1, t2 = q[0], q[-1]
        jd, jn = je.phrase(js, jnp.uint32(t1), jnp.uint32(t2))
        td, tn = te.phrase(ts, torch.tensor(t1), torch.tensor(t2))
        assert int(jn) == int(tn)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd, np.int64))
        assert int(je.read_all(js, jt, jnp.int32(len(q)))) == \
            int(te.read_all(ts, tt, torch.tensor(len(q))))
        for t in q:
            for name in ("postings_desc", "docids_asc"):
                jv, jn = getattr(je, name)(js, jnp.uint32(t))
                tv, tn = getattr(te, name)(ts, torch.tensor(t))
                assert int(jn) == int(tn)
                np.testing.assert_array_equal(tv.numpy(),
                                              np.asarray(jv, np.int64))


def test_phrase_hits_adjacent_pairs(both):
    """Phrase queries built from real adjacent pairs (so they hit)."""
    je = jqry.make_engine(both["jl"], both["ms"], both["max_len"], 4)
    te = tqry.make_engine(both["tl"], both["ms"], both["max_len"], 4)
    docs = both["docs"]
    hits = 0
    for d in range(0, 60, 3):
        t1, t2 = int(docs[d, 0]), int(docs[d, 1])
        if t2 < 0:
            continue
        jd, jn = je.phrase(both["jseg"].state, jnp.uint32(t1),
                           jnp.uint32(t2))
        td, tn = te.phrase(both["tseg"].state, torch.tensor(t1),
                           torch.tensor(t2))
        assert int(jn) == int(tn) and int(tn) > 0
        hits += int(tn)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd, np.int64))
    assert hits


@pytest.mark.parametrize("kind", ["conjunctive", "disjunctive", "phrase"])
def test_batched_active_fn_matches(both, kind):
    tb = 4
    jterms, jn = jq.pad_query_batch(both["queries"], tb)
    tterms, tn = tq.pad_query_batch(both["queries"], tb)
    np.testing.assert_array_equal(tterms, jterms.astype(np.int64))
    jfn = jq.make_active_fn(both["jl"], both["ms"], both["max_len"], tb,
                            kind)
    tfn = tq.make_active_fn(both["tl"], both["ms"], both["max_len"], tb,
                            kind)
    if kind == "phrase":
        jargs = (jnp.asarray(jterms[:, 0]), jnp.asarray(jterms[:, 1]))
        targs = (torch.as_tensor(tterms[:, 0]), torch.as_tensor(tterms[:, 1]))
    else:
        jargs = (jnp.asarray(jterms), jnp.asarray(jn))
        targs = (torch.as_tensor(tterms), torch.as_tensor(tn))
    jd, jcnt = jfn(both["jseg"].state, *jargs)
    td, tcnt = tfn(both["tseg"].state, *targs)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd, np.int64))


@pytest.mark.parametrize("k", [1, 5, 40])
def test_active_topk_fn_matches(both, k):
    tb, k_pad = 4, max(8, 1 << (k - 1).bit_length())
    jterms, jn = jq.pad_query_batch(both["queries"], tb)
    jfn = jq.make_active_topk_fn(both["jl"], both["ms"], both["max_len"],
                                 tb, k_pad)
    tfn = tq.make_active_topk_fn(both["tl"], both["ms"], both["max_len"],
                                 tb, k_pad)
    jd, jcnt = jfn(both["jseg"].state, jnp.asarray(jterms),
                   jnp.asarray(jn), jnp.int32(k))
    td, tcnt = tfn(both["tseg"].state, torch.as_tensor(jterms.astype(
        np.int64)), torch.as_tensor(jn), k)
    jd, jcnt = jax.device_get((jd, jcnt))
    np.testing.assert_array_equal(tcnt.numpy(), jcnt)
    for i, n in enumerate(jcnt):       # lanes past n are unspecified
        np.testing.assert_array_equal(td.numpy()[i, :n],
                                      jd[i, :n].astype(np.int64))


def test_set_op_helpers_match():
    rng = np.random.default_rng(2)
    a = np.full(64, 0xFFFFFFFF, np.uint32)
    b = a.copy()
    x = np.unique(rng.integers(0, 200, 40)).astype(np.uint32)
    y = np.unique(rng.integers(0, 200, 50)).astype(np.uint32)
    a[: x.size], b[: y.size] = x, y
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.as_tensor(a.astype(np.int64)), \
        torch.as_tensor(b.astype(np.int64))
    np.testing.assert_array_equal(tqry.member_asc(ta, tb).numpy(),
                                  np.asarray(jqry.member_asc(ja, jb)))
    for jf, tf in ((jqry.union_asc, tqry.union_asc),
                   (jqry.intersect_asc, tqry.intersect_asc)):
        jv, jc = jf(ja, x.size, jb, y.size)
        tv, tc = tf(ta, x.size, tb, y.size)
        assert int(jc) == int(tc)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv, np.int64))
    dup = np.sort(np.concatenate([x, x[:10]]))
    dd = np.full(64, 0xFFFFFFFF, np.uint32)
    dd[: dup.size] = dup
    jv, jc = jqry.dedup_asc(jnp.asarray(dd))
    tv, tc = tqry.dedup_asc(torch.as_tensor(dd.astype(np.int64)))
    assert int(jc) == int(tc)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv, np.int64))
    n = torch.tensor(x.size)
    np.testing.assert_array_equal(
        tqry.asc_to_desc(ta, n).numpy(),
        np.asarray(jqry.asc_to_desc(ja, jnp.int32(x.size)), np.int64))


def test_scored_engine_member_not_ported(both):
    """``conjunctive_scored_asc`` (now ported): docids, summed impacts
    and counts equal the reference's, query by query and batched."""
    mq = 4
    je = jqry.make_engine(both["jl"], both["ms"], both["max_len"], mq)
    te = tqry.make_engine(both["tl"], both["ms"], both["max_len"], mq)
    terms, n_terms = tq.pad_query_batch(both["queries"], mq)
    ba, bs, bn = te.conjunctive_scored_asc(
        both["tseg"].state, torch.as_tensor(terms),
        torch.as_tensor(n_terms))
    scored = 0
    for i, q in enumerate(both["queries"]):
        ja, js, jn = je.conjunctive_scored_asc(
            both["jseg"].state, jnp.asarray(terms[i], jnp.uint32),
            jnp.int32(len(q)))
        assert int(bn[i]) == int(jn)
        np.testing.assert_array_equal(ba[i].numpy(),
                                      np.asarray(ja, np.int64))
        np.testing.assert_array_equal(bs[i].numpy(), np.asarray(js))
        scored += int(np.asarray(js).sum())
    assert scored > 0 and bs.dtype == torch.int32


def test_merge_desc_matches():
    from repro.core import sharded_index as jsh
    from repro_torch.core import sharded_index as tsh
    rng = np.random.default_rng(6)
    lists = np.full((4, 32), 0xFFFFFFFF, np.uint32)
    ns = []
    for s in range(4):                       # disjoint residue classes
        ids = np.unique(rng.integers(0, 500, 20)) * 4 + s
        lists[s, : ids.size] = ids[::-1]
        ns.append(ids.size)
    want = np.asarray(jsh.merge_desc(jnp.asarray(lists.reshape(-1))))
    got = tsh.merge_desc(torch.as_tensor(lists.reshape(-1).astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    for k in (None, 5):
        jd, jn = jsh.topk_merge_desc(jnp.asarray(lists), jnp.asarray(ns), k)
        td, tn = tsh.topk_merge_desc(
            torch.as_tensor(lists.astype(np.int64)), torch.as_tensor(ns), k)
        assert int(jn) == int(tn)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd, np.int64))
