"""Port vs reference: the invariant validators and the sanitized routes.

A JAX engine and a port engine (on the CPU, both ``validate=True``)
take the same stream through rollovers; the port's state is checked
equal to the reference's.  Each corruption of ``tests/test_analysis.py``
(and a few more) is then applied to the same numpy leaves on both sides
— the pool state carried across with ``convert.pool_state_from_numpy``
— and the two packages' reports must agree on ``ok``, on the set of
violated fields and on ``stats``.  The sanitized (``checked=True``)
routes must equal the unchecked ones on clean inputs, go through the
kernel wrapper where the tensors are on the card, and raise on the
seeded out-of-range gather that the plain versions clamp.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import invariants as jinv
from repro.core import analytical
from repro.core import lifecycle as jl
from repro.core import pointers as jp
from repro.core import slicepool as jsp
from repro.data import synth
from repro.kernels import segment_intersect as jsi
from repro_torch.analysis import invariants as tinv
from repro_torch.analysis import sanitize
from repro_torch.core import convert
from repro_torch.core import lifecycle as tl
from repro_torch.core import pointers as tp
from repro_torch.kernels import ops, ref
from repro_torch.kernels import segment_intersect as tsi

Z, SPP = (1, 4, 7, 11), (4096, 2048, 512, 64)
JLAYOUT = jp.PoolLayout(z=Z, slices_per_pool=SPP)
TLAYOUT = tp.PoolLayout(z=Z, slices_per_pool=SPP)
RNG = np.random.default_rng(0)


def _stream(seed, vocab, n_docs):
    docs = synth.zipf_corpus(synth.CorpusSpec(vocab=vocab, n_docs=n_docs,
                                              seed=seed))
    fmax = max(int(synth.term_freqs(docs, vocab).max()), 1)
    kw = dict(max_slices=int(analytical.slices_needed(Z, fmax)) + 1,
              max_len=1 << (fmax - 1).bit_length(), use_kernel=False,
              validate=True)
    return docs, kw


def _pair(seed=5, vocab=400, n_docs=380, docs_per_segment=140):
    docs, kw = _stream(seed, vocab, n_docs)
    j = jl.LifecycleEngine(JLAYOUT, vocab, docs_per_segment, **kw)
    t = tl.LifecycleEngine(TLAYOUT, vocab, docs_per_segment, device="cpu",
                           **kw)
    for i in range(0, n_docs, 20):
        j.ingest(jnp.asarray(docs[i: i + 20]))
        t.ingest(docs[i: i + 20])
    return j, t


def _leaves(j):
    return {f: np.array(getattr(j.segments.active.state, f))
            for f in jsp.PoolState._fields}


@pytest.fixture(scope="module")
def engines():
    j, t = _pair()
    assert t.stats.rollovers >= 2
    got = convert.pool_state_to_numpy(t.segments.active.state)
    for f, v in _leaves(j).items():
        np.testing.assert_array_equal(got[f], v, err_msg=f)
    return j, t


def assert_reports_agree(want, got):
    assert got.ok == want.ok, (want.render(), got.render())
    assert {v.field for v in got.violations} == \
        {v.field for v in want.violations}, (want.render(), got.render())
    assert got.stats == want.stats


def pool_reports(leaves, layouts=(JLAYOUT, TLAYOUT)):
    want = jinv.check_pool_state(layouts[0], jsp.PoolState(
        **{f: jnp.asarray(v) for f, v in leaves.items()}))
    got = tinv.check_pool_state(
        layouts[1], convert.pool_state_from_numpy(leaves, "cpu"))
    assert_reports_agree(want, got)
    return want, got


# ---------------------------------------------------------------------------
# check_pool_state: clean and corrupted leaves, the same on both sides
# ---------------------------------------------------------------------------
def _first_live(lv):
    return int(np.nonzero(lv["freq"] > 0)[0][0])


def _deep_term(lv):
    """A term whose chain reaches pool >= 2 (at least three slices)."""
    return int(np.argmax(lv["freq"]))


def _dangling_free_slice(lv):
    p = int(np.argmax(lv["free_count"] > 0))
    lv["free_list"][JLAYOUT.free_base[p]] = int(lv["watermark"][p]) + 5


def _live_slice_on_free_list(lv):
    pool, sl, _ = jp.decode_host(JLAYOUT, int(lv["tail"][_first_live(lv)]))
    lv["free_list"][JLAYOUT.free_base[pool] + lv["free_count"][pool]] = sl
    lv["free_count"][pool] += 1


def _freq_chain_mismatch(lv):
    lv["freq"][_first_live(lv)] += 3


def _leaked_slice(lv):
    p = int(np.argmax(lv["free_count"] > 0))
    lv["free_count"][p] -= 1


def _duplicate_free_entry(lv):
    p = int(np.argmax(lv["free_count"] > 1))
    b = JLAYOUT.free_base[p]
    lv["free_list"][b + 1] = lv["free_list"][b]


def _null_tail_live_term(lv):
    lv["tail"][_first_live(lv)] = 0xFFFFFFFF


def _stray_tail(lv):
    t = int(np.nonzero(lv["freq"] == 0)[0][0])
    lv["tail"][t] = lv["tail"][_first_live(lv)]


def _chain_cycle(lv):
    """The tail slice's previous-pointer points back at itself."""
    ptr = int(lv["tail"][_deep_term(lv)])
    pool, sl, _ = jp.decode_host(JLAYOUT, ptr)
    assert pool > 0
    base = JLAYOUT.pool_base[pool] + sl * JLAYOUT.slice_sizes[pool]
    lv["heap"][base] = ptr


def _chain_out_of_range(lv):
    ptr = int(lv["tail"][_deep_term(lv)])
    pool, _, off = jp.decode_host(JLAYOUT, ptr)
    lv["tail"][_deep_term(lv)] = jp.encode_host(
        JLAYOUT, pool, int(lv["watermark"][pool]) + 1, off)


def _watermark_over_capacity(lv):
    lv["watermark"][0] = SPP[0] + 1


def _free_count_over_watermark(lv):
    lv["free_count"][1] = lv["watermark"][1] + 1


def _heap_shape(lv):
    lv["heap"] = lv["heap"][:-1]


def _overflow_shape(lv):
    lv["overflow"] = np.zeros(2, np.bool_)


POOL_CORRUPTIONS = [None, _dangling_free_slice, _live_slice_on_free_list,
                    _freq_chain_mismatch, _leaked_slice,
                    _duplicate_free_entry, _null_tail_live_term,
                    _stray_tail, _chain_cycle, _chain_out_of_range,
                    _watermark_over_capacity, _free_count_over_watermark,
                    _heap_shape, _overflow_shape]


@pytest.mark.parametrize("corrupt", POOL_CORRUPTIONS,
                         ids=lambda f: f.__name__[1:] if f else "clean")
def test_pool_state_reports_agree(engines, corrupt):
    j, _ = engines
    lv = _leaves(j)
    if corrupt is not None:
        corrupt(lv)
    want, got = pool_reports(lv)
    assert got.ok == (corrupt is None)
    if corrupt is None:
        assert got.stats["chains_walked"] > 0
    if corrupt is _live_slice_on_free_list:
        assert any("BOTH live and on the free list" in v.message
                   for v in got.violations)


def test_pool_state_of_the_port_engine(engines):
    """The port engine's own state (not carried across) reports like the
    reference engine's."""
    j, t = engines
    assert_reports_agree(
        jinv.check_pool_state(JLAYOUT, j.segments.active.state),
        tinv.check_pool_state(TLAYOUT, t.segments.active.state))


def test_stacked_state_reports_agree(engines):
    """A ``[S, ...]`` stack of per-shard states is checked shard by
    shard, with a corruption in one shard named with its prefix."""
    j, _ = engines
    lv = _leaves(j)
    bad = {f: v.copy() for f, v in lv.items()}
    _freq_chain_mismatch(bad)
    stacked = {f: np.stack([lv[f], bad[f]]) for f in lv}
    want, got = pool_reports(stacked)
    assert not got.ok and got.stats["shards"] == 2
    assert all(v.field.startswith("shard 1: ") for v in got.violations)


def test_single_pool_layout_reports_agree():
    """One pool links no continuation slices: only the tail slice is
    reachable and the partition relaxes to an upper bound."""
    layouts = (jp.PoolLayout(z=(3,), slices_per_pool=(512,)),
               tp.PoolLayout(z=(3,), slices_per_pool=(512,)))
    docs, _ = _stream(1, 60, 120)
    j = jl.LifecycleEngine(layouts[0], 60, 1000, max_slices=300,
                           max_len=512, use_kernel=False)
    j.ingest(jnp.asarray(docs))
    lv = _leaves(j)
    want, got = pool_reports(lv, layouts)
    assert got.ok and got.stats["chains_walked"] > 0
    _freq_chain_mismatch(lv)
    assert not pool_reports(lv, layouts)[1].ok
    lv["freq"][_first_live(lv)] += 5      # a whole slice more: unseen
    assert pool_reports(lv, layouts)[1].ok


# ---------------------------------------------------------------------------
# frozen segments, the segment set, the whole engine
# ---------------------------------------------------------------------------
def _frozen_pair(engines, i=0):
    j, t = engines
    return j.segments.frozen[i], t.segments.frozen[i]


def _non_monotone(fz):
    o = fz.offsets.copy()
    k = int(np.argmax(np.diff(o) > 0))
    o[k + 1] = o[k] - 1
    return dict(offsets=o)


def _unsorted(fz):
    d = fz.data.copy()
    k = int(np.argmax(np.diff(fz.offsets) >= 2))
    a = int(fz.offsets[k])
    d[a], d[a + 1] = d[a + 1], d[a]
    return dict(data=d)


def _short_data(fz):
    return dict(data=fz.data[:-1].copy())


def _docid_past_n_docs(fz):
    return dict(n_docs=1)


def _offsets_dtype(fz):
    return dict(offsets=fz.offsets.astype(np.int32))


def _duplicate_freed(fz):
    fr = [np.asarray(x).copy() for x in fz.freed_slices]
    p = int(np.argmax([x.size > 1 for x in fr]))
    fr[p][1] = fr[p][0]
    return dict(freed_slices=fr)


FROZEN_CORRUPTIONS = [None, _non_monotone, _unsorted, _short_data,
                      _docid_past_n_docs, _offsets_dtype, _duplicate_freed]


@pytest.mark.parametrize("corrupt", FROZEN_CORRUPTIONS,
                         ids=lambda f: f.__name__[1:] if f else "clean")
def test_frozen_segment_reports_agree(engines, corrupt):
    jz, tz = _frozen_pair(engines, -1)
    if corrupt is not None:
        jz = dataclasses.replace(jz, **corrupt(jz))
        tz = dataclasses.replace(tz, **corrupt(tz))
    want = jinv.check_frozen_segment(jz, layout=JLAYOUT)
    got = tinv.check_frozen_segment(tz, layout=TLAYOUT)
    assert_reports_agree(want, got)
    assert got.ok == (corrupt is None)


def test_frozen_segment_scored_planes_agree(engines):
    j, t = engines
    jp_seg, tp_seg = j.frozen_packed[0], t.frozen_packed[0]
    terms = [int(x) for x in np.nonzero(np.diff(jp_seg.seg.offsets))[0][:30]]
    for bad in (False, True):
        jsc = [(x, jp_seg.scored(x)) for x in terms]
        tsc = [(x, tp_seg.scored(x)) for x in terms]
        if bad:     # one impact lane off by one in both packages
            sw = np.asarray(jsc[0][1].swords).copy()
            sw[0] ^= 1
            jsc[0] = (terms[0], jsc[0][1]._replace(swords=sw))
            tsc[0] = (terms[0], tsc[0][1]._replace(swords=sw))
        want = jinv.check_frozen_segment(jp_seg.seg, scored=jsc)
        got = tinv.check_frozen_segment(tp_seg.seg, scored=tsc)
        assert_reports_agree(want, got)
        assert got.ok != bad


class _FakeSet:
    def __init__(self, frozen, doc_base, max_segments=12):
        self.frozen = frozen
        self._doc_base = doc_base
        self.max_segments = max_segments


def _set_cases(frozen, base):
    f0, f1 = frozen[0], frozen[1]
    shift = dataclasses.replace(f1, doc_base=f0.doc_base)
    gap = dataclasses.replace(f1, doc_base=f1.doc_base + 3)
    up = dataclasses.replace(f1, tier=5)
    return {"clean": (_FakeSet(frozen, base), None),
            "overlap": (_FakeSet([f0, shift], base), None),
            "gap": (_FakeSet([f0, gap], base), None),
            "active_base": (_FakeSet(frozen, base + 1), None),
            "too_many": (_FakeSet(frozen, base, max_segments=2), None),
            "tier_up": (_FakeSet([f0, up], base), 2),
            "tier_run": (_FakeSet([f0, f1], base), 2)}


@pytest.mark.parametrize("case", ["clean", "overlap", "gap", "active_base",
                                  "too_many", "tier_up", "tier_run"])
def test_segment_set_reports_agree(engines, case):
    j, t = engines
    jset, fan = _set_cases(j.segments.frozen, j.segments._doc_base)[case]
    tset, _ = _set_cases(t.segments.frozen, t.segments._doc_base)[case]
    want = jinv.check_segment_set(jset, layout=JLAYOUT, fanout=fan)
    got = tinv.check_segment_set(tset, layout=TLAYOUT, fanout=fan)
    assert_reports_agree(want, got)
    assert got.ok == (case == "clean")


def test_engine_reports_agree(engines):
    j, t = engines
    want, got = jinv.check_engine(j), tinv.check_engine(t)
    assert_reports_agree(want, got)
    assert got.ok and got.stats["chains_walked"] > 0
    t.validate_invariants()


# ---------------------------------------------------------------------------
# stacked lists (the query-side packing), plain and scored
# ---------------------------------------------------------------------------
def _rand_asc(n, hi, rng):
    return np.sort(rng.choice(hi, n, replace=False)).astype(np.uint32)


def _stacks(seed):
    rng = np.random.default_rng(seed)
    lists = [_rand_asc(130, 2000, rng), _rand_asc(5, 50, rng),
             _rand_asc(300, 100_000, rng), np.zeros(0, np.uint32)]
    scores = [rng.integers(1, 256, x.size) for x in lists]
    js = jsi.stack_packed([jsi.pack_docids(x) for x in lists])
    ts = tsi.stack_packed([tsi.pack_docids(x) for x in lists])
    jsc = jsi.stack_scored([jsi.pack_scored(x, s) for x, s in
                            zip(lists, scores)])
    tsc = tsi.stack_scored([tsi.pack_scored(x, s) for x, s in
                            zip(lists, scores)])
    return js, ts, jsc, tsc


def _bad_pad_block(s):
    payload = s.payload.copy()
    payload[1, int(s.woffs[1, -1]) + 3] = 7
    return s._replace(payload=payload)


def _oob_woffs(s):
    return s._replace(woffs=s.woffs + s.payload.shape[-1])


def _bad_width(s):
    bws = s.bws.copy()
    bws[0, 0] = 3
    return s._replace(bws=bws)


def _ns_past_blocks(s):
    ns = s.ns.copy()
    ns[2] = s.firsts.shape[-1] * 128 + 1
    return s._replace(ns=ns)


def _descending_lanes(s):
    firsts = s.firsts.copy()
    firsts[2, 1] = 0
    return s._replace(firsts=firsts)


STACK_CORRUPTIONS = [None, _bad_pad_block, _oob_woffs, _bad_width,
                     _ns_past_blocks, _descending_lanes]


@pytest.mark.parametrize("corrupt", STACK_CORRUPTIONS,
                         ids=lambda f: f.__name__[1:] if f else "clean")
@pytest.mark.parametrize("seed", [0, 1])
def test_stacked_lists_reports_agree(corrupt, seed):
    js, ts, _, _ = _stacks(seed)
    np.testing.assert_array_equal(ts.payload, js.payload)
    if corrupt is not None:
        js, ts = corrupt(js), corrupt(ts)
    want = jinv.check_stacked_lists(js)
    got = tinv.check_stacked_lists(ts)
    assert_reports_agree(want, got)
    assert got.ok == (corrupt is None)
    # torch leaves report the same
    assert_reports_agree(want, tinv.check_stacked_lists(ts.to("cpu")))


def _bmax_drift(s):
    bm = s.bmax.copy()
    bm[0, 0] -= 1
    return s._replace(bmax=bm)


def _impact_past_ns(s):
    sw = s.swords.copy()
    sw[1, -1] = 5
    return s._replace(swords=sw)


def _zero_impact(s):
    sw = s.swords.copy()
    sw[0, 0] &= 0xFFFFFF00
    return s._replace(swords=sw)


@pytest.mark.parametrize("corrupt", [None, _bmax_drift, _impact_past_ns,
                                     _zero_impact],
                         ids=lambda f: f.__name__[1:] if f else "clean")
def test_scored_stack_reports_agree(corrupt):
    _, _, jsc, tsc = _stacks(3)
    if corrupt is not None:
        jsc, tsc = corrupt(jsc), corrupt(tsc)
    want = jinv.check_stacked_lists(jsc)
    got = tinv.check_stacked_lists(tsc)
    assert_reports_agree(want, got)
    assert got.ok == (corrupt is None)


# ---------------------------------------------------------------------------
# validate=True at rollover, restore-time validation
# ---------------------------------------------------------------------------
def test_validate_flag_catches_leak_at_rollover():
    """The seeded fault of the reference's test: a LEAKED slice
    (free_count decremented) upsets no pointer, no chain and no range
    guard; only the live + free == watermark partition sees it, at the
    next rollover, in both packages."""
    j, t = _pair(seed=9, n_docs=150, docs_per_segment=140)
    assert t.stats.rollovers >= 1
    for eng, ns in ((j, jnp), (t, None)):
        st = eng.segments.active.state
        fc = np.asarray(st.free_count).copy()
        p = int(np.argmax(fc > 0))
        fc[p] -= 1
        eng.segments.active.state = st._replace(
            free_count=(ns.asarray(fc) if ns else torch.as_tensor(fc)))
    docs, _ = _stream(11, 400, 300)
    for eng, exc in ((j, jinv.InvariantViolation),
                     (t, tinv.InvariantViolation)):
        with pytest.raises(exc, match="leaked"):
            for i in range(0, 300, 20):
                eng.ingest(docs[i: i + 20])


def test_report_api():
    rep = tinv.Report("x")
    assert rep.ok and "ok" in rep.render()
    rep.add_each("f", range(12), lambda i: f"item {i}")
    assert len(rep.violations) == tinv._LIST_CAP + 1
    assert "4 more" in rep.violations[-1].message
    with pytest.raises(tinv.InvariantViolation, match="item 0"):
        rep.raise_if_failed()


# ---------------------------------------------------------------------------
# the sanitized routes
# ---------------------------------------------------------------------------
def _torch_stack(lists):
    return tsi.stack_packed([tsi.pack_docids(x) for x in lists]).to("cpu")


def test_checked_routes_match_unchecked():
    rng = np.random.default_rng(4)
    a, b = _rand_asc(300, 4000, rng), _rand_asc(200, 4000, rng)
    A = tsi.pack_docids(a).to("cpu")
    B = tsi.pack_docids(b).to("cpu")
    torch.testing.assert_close(ops.segment_intersect_mask(A, B, checked=True),
                               ops.segment_intersect_mask(A, B),
                               rtol=0, atol=0)
    SA, SB = _torch_stack([a, a[:50]]), _torch_stack([b, b[:70]])
    torch.testing.assert_close(
        ops.segment_intersect_mask_batched(SA, SB, checked=True),
        ops.segment_intersect_mask_batched(SA, SB), rtol=0, atol=0)
    pa = torch.full((2, 256), 0xFFFFFFFF, dtype=torch.int64)
    pb = torch.full((2, 256), 0xFFFFFFFF, dtype=torch.int64)
    pa[:, :90] = torch.as_tensor(_rand_asc(90, 500, rng).astype(np.int64))
    pb[:, :120] = torch.as_tensor(_rand_asc(120, 500, rng).astype(np.int64))
    torch.testing.assert_close(ops.intersect_mask(pa, pb, checked=True),
                               ops.intersect_mask(pa, pb), rtol=0, atol=0)
    sa = tsi.stack_scored([tsi.pack_scored(a, rng.integers(1, 256, a.size)),
                           tsi.pack_scored(a[:9], np.ones(9, np.int64))]
                          ).to("cpu")
    sb = tsi.stack_scored([tsi.pack_scored(b, rng.integers(1, 256, b.size)),
                           tsi.pack_scored(b[:7], np.ones(7, np.int64))]
                          ).to("cpu")
    for th in (-1, 200):
        rest = torch.tensor([255, 3], dtype=torch.int32)
        th = torch.full((2,), th, dtype=torch.int32)
        torch.testing.assert_close(
            ops.scored_intersect_batched(sa, sb, rest, th, checked=True),
            ops.scored_intersect_batched(sa, sb, rest, th), rtol=0, atol=0)


def _bulk_args(skip: bool):
    H, V, N = 64, 8, 12
    perm = RNG.permutation(H)
    post_addr = torch.as_tensor(perm[:N].astype(np.int64))
    ptr_addr = torch.as_tensor(perm[N: 2 * N].astype(np.int64))
    if skip:
        ptr_addr = torch.full((N,), H + 1, dtype=torch.int64)
    return (torch.zeros(H, dtype=torch.int64),
            torch.full((V,), 0xFFFFFFFF, dtype=torch.int64),
            torch.zeros(V, dtype=torch.int32), post_addr,
            torch.as_tensor(RNG.integers(1, 99, N)), ptr_addr,
            torch.zeros(N, dtype=torch.int64),
            torch.as_tensor(np.arange(N) % V),
            torch.as_tensor(RNG.integers(0, 9, N)),
            torch.ones(N, dtype=torch.int32))


def test_checked_bulk_append():
    """A fully dense batch: the checked route equals the plain version;
    a skip lane (the allocator's out-of-range drop encoding) raises,
    and the target is left untouched (the check runs first)."""
    args = _bulk_args(skip=False)
    want = ref.bulk_append_ref(*[a.clone() for a in args])
    got = ops.bulk_append(*[a.clone() for a in args], checked=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    args = _bulk_args(skip=True)
    heap = args[0].clone()
    with pytest.raises(sanitize.SanitizerError, match="ptr_addr"):
        ops.bulk_append(*args, checked=True)
    assert torch.equal(args[0], heap)
    ops.bulk_append(*args)                        # the skip contract


def test_seeded_oob_gather_is_caught():
    """The reference's seeded fault: a word-offset table corrupted so the
    slab gather reads out of bounds.  The unchecked plain version clamps
    silently (as the reference's oracle does); the checked route raises
    before the clamp can hide it, in the port as in the reference."""
    rng = np.random.default_rng(6)
    a, b = [_rand_asc(100, 5000, rng)], [_rand_asc(80, 5000, rng)]
    SA, SB = _torch_stack(a), _torch_stack(b)
    bad = SA._replace(woffs=SA.woffs + 10_000)
    ops.segment_intersect_mask_batched(bad, SB)    # clamps, no error
    with pytest.raises(sanitize.SanitizerError, match="woffs"):
        ops.segment_intersect_mask_batched(bad, SB, checked=True)
    from repro.analysis import sanitize as jsan
    from repro.kernels import ops as jops
    import jax
    jA = jax.tree.map(jnp.asarray, jsi.stack_packed(
        [jsi.pack_docids(x) for x in a]))
    jB = jax.tree.map(jnp.asarray, jsi.stack_packed(
        [jsi.pack_docids(x) for x in b]))
    with pytest.raises(jsan.SanitizerError):
        jops.segment_intersect_mask_batched(
            jA._replace(woffs=jA.woffs + jnp.int32(10_000)), jB,
            checked=True)
    A = tsi.pack_docids(a[0]).to("cpu")
    with pytest.raises(sanitize.SanitizerError, match="woffs"):
        ops.segment_intersect_mask(A._replace(woffs=A.woffs - 1), A,
                                   checked=True)
    sc = tsi.stack_scored([tsi.pack_scored(a[0], np.ones(100, np.int64))]
                          ).to("cpu")
    bad_sc = sc._replace(ids=sc.ids._replace(woffs=sc.ids.woffs + 10_000))
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(sanitize.SanitizerError, match="woffs"):
        ops.scored_intersect_batched(bad_sc, sc, one, one - 1, checked=True)


def _route_cases():
    """(route, kernel module, clean args, args that fail the bounds) for
    each checked route."""
    rng = np.random.default_rng(9)
    a, b = _rand_asc(150, 3000, rng), _rand_asc(120, 3000, rng)
    A, B = tsi.pack_docids(a).to("cpu"), tsi.pack_docids(b).to("cpu")
    SA, SB = _torch_stack([a, a[:40]]), _torch_stack([b, b[:60]])
    sa = tsi.stack_scored([tsi.pack_scored(a, rng.integers(1, 256, a.size))]
                          ).to("cpu")
    sb = tsi.stack_scored([tsi.pack_scored(b, rng.integers(1, 256, b.size))]
                          ).to("cpu")
    one = torch.zeros(1, dtype=torch.int32)
    pa = torch.full((1, 256), 0xFFFFFFFF, dtype=torch.int64)
    pa[0, :150] = torch.as_tensor(a.astype(np.int64))
    dense, skip = _bulk_args(skip=False), _bulk_args(skip=True)
    far = lambda s: s._replace(woffs=s.woffs + 10_000)  # noqa: E731
    return [
        ("intersect_mask", ops._pi, (pa, pa.clone()),
         (pa, torch.zeros(2, 256, dtype=torch.int64))),
        ("segment_intersect_mask", ops._si, (A, B), (far(A), B)),
        ("segment_intersect_mask_batched", ops._si, (SA, SB), (far(SA), SB)),
        ("scored_intersect_batched", ops._si, (sa, sb, one, one - 1),
         (sa._replace(ids=far(sa.ids)), sb, one, one - 1)),
        ("bulk_append", ops._ba, dense, skip),
    ]


@pytest.mark.parametrize("route", [c[0] for c in _route_cases()])
def test_checked_route_dispatches_by_device(route, monkeypatch):
    """The checked route runs the call ``ops`` routes by device: with
    the tensors taken for CUDA ones, it launches the kernel wrapper (a
    spy here) after the bounds pass, and launches nothing when they
    fail."""
    name, mod, good, bad = next(c for c in _route_cases() if c[0] == route)
    plain = getattr(ref, name + "_ref")
    calls = []

    def spy(*args):
        calls.append(args)
        return plain(*args)

    monkeypatch.setattr(ops, "_on_cuda", lambda _name, _t: True)
    monkeypatch.setattr(mod, name, spy)
    want = plain(*[x.clone() if isinstance(x, torch.Tensor) else x
                   for x in good])
    got = getattr(ops, name)(*good, checked=True)
    assert len(calls) == 1
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(sanitize.SanitizerError):
        getattr(ops, name)(*bad, checked=True)
    assert len(calls) == 1


def test_sanitized_wrapper_nan_and_zero_division():
    f = sanitize.sanitized(lambda x: torch.sqrt(x).sum())
    assert float(f(torch.tensor([4.0, 9.0]))) == 5.0
    with pytest.raises(sanitize.SanitizerError, match="NaN"):
        f(torch.tensor([-1.0]))
    g = sanitize.sanitized(lambda x, y: x // y)
    with pytest.raises(sanitize.SanitizerError, match="division by zero"):
        g(torch.tensor([3]), torch.tensor([0]))
    with pytest.raises(sanitize.SanitizerError, match="rows|dims"):
        ops.intersect_mask(torch.zeros(2, 4, dtype=torch.int64),
                           torch.zeros(3, 4, dtype=torch.int64),
                           checked=True)
