"""Port vs reference: slice-pool ingest, reclamation, chain walks.

Identical numpy-seeded (term, posting) streams go through the JAX
package's scan oracle and bulk allocator and through the port's bulk
allocator and scan oracle (on the CPU, where ``bulk_append`` runs its
plain version).  All seven ``PoolState`` leaves must be equal after
every batch and after every release; the frozen CSR and the freed-slice
order the port's freeze reports must equal the reference's.  Streams
cover sticky overflow, SP start pools, recycled slices and the argsort
key fallback.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pointers as jp
from repro.core import segments as jseg
from repro.core import slicepool as jsp
from repro_torch.core import convert
from repro_torch.core import pointers as tp
from repro_torch.core import segments as tseg
from repro_torch.core import slicepool as tsp

LAYOUTS = (
    ((1, 4), (2, 1)),
    ((1, 4), (8, 3)),
    ((0, 2, 5), (16, 6, 2)),
    ((1, 4, 7, 11), (64, 32, 16, 8)),
    ((3,), (12,)),
)


def _leaves_j(state):
    return {f: np.asarray(getattr(state, f)) for f in jsp.PoolState._fields}


def assert_equal_states(js, ts, ctx):
    want = _leaves_j(js)
    got = convert.pool_state_to_numpy(ts)
    for f in want:
        assert want[f].dtype == got[f].dtype, (ctx, f)
        assert np.array_equal(want[f], got[f]), f"{ctx}: leaf {f} differs"


def run_all(li, vocab, batches, sp_per_term=None, release_every=None):
    """Feed identical batches to the reference scan + bulk and the port
    bulk + scan; compare every leaf after every batch and release."""
    z, spp = LAYOUTS[li] if isinstance(li, int) else li
    jl = jp.PoolLayout(z=z, slices_per_pool=spp)
    tl = tp.PoolLayout(z=z, slices_per_pool=spp)
    j_scan, j_bulk = jsp.make_ingest_fn(jl, vocab), \
        jsp.make_bulk_ingest_fn(jl, vocab)
    t_bulk = tsp.make_bulk_ingest_fn(tl, vocab, "cpu")
    t_scan = tsp.make_ingest_fn(tl, vocab)
    s_js, s_jb = jsp.init_state(jl, vocab), jsp.init_state(jl, vocab)
    s_tb, s_ts = (tsp.init_state(tl, vocab, "cpu"),
                  tsp.init_state(tl, vocab, "cpu"))
    for bi, (terms, posts) in enumerate(batches):
        sp = None if sp_per_term is None else \
            np.asarray(sp_per_term, np.int64)[terms]
        jsp_arg = None if sp is None else jnp.asarray(sp, jnp.uint32)
        s_js = j_scan(s_js, jnp.asarray(terms, jnp.uint32),
                      jnp.asarray(posts, jnp.uint32), jsp_arg)
        s_jb = j_bulk(s_jb, jnp.asarray(terms, jnp.uint32),
                      jnp.asarray(posts, jnp.uint32), jsp_arg)
        tsp_arg = None if sp is None else torch.as_tensor(sp)
        s_tb = t_bulk(s_tb, torch.as_tensor(terms.astype(np.int64)),
                      torch.as_tensor(posts.astype(np.int64)), tsp_arg)
        s_ts = t_scan(s_ts, torch.as_tensor(terms.astype(np.int64)),
                      torch.as_tensor(posts.astype(np.int64)), tsp_arg)
        for name, js in (("scan", s_js), ("bulk", s_jb)):
            assert_equal_states(js, s_tb, f"batch {bi} port bulk vs {name}")
        assert_equal_states(s_js, s_ts, f"batch {bi} port scan")
        if (release_every and (bi + 1) % release_every == 0
                and not bool(s_js.overflow)):
            jfz = jseg.freeze_state(jl, np.asarray(s_js.heap),
                                    np.asarray(s_js.tail),
                                    np.asarray(s_js.freq), n_docs=1)
            tfz = tseg.freeze_state(tl, s_tb.heap, s_tb.tail, s_tb.freq,
                                    n_docs=1)
            np.testing.assert_array_equal(tfz.offsets, jfz.offsets)
            np.testing.assert_array_equal(tfz.data, jfz.data)
            for a, b in zip(tfz.freed_slices, jfz.freed_slices):
                np.testing.assert_array_equal(a, b)
            s_js = jsp.release_slices(jl, s_js, jfz.freed_slices)
            s_jb = jsp.release_slices(jl, s_jb, jfz.freed_slices)
            s_tb = tsp.release_slices(tl, s_tb, tfz.freed_slices)
            s_ts = tsp.release_slices(tl, s_ts, tfz.freed_slices)
            assert_equal_states(s_js, s_tb, f"release after {bi}")
            assert_equal_states(s_js, s_ts, f"release after {bi} (scan)")
    return s_js, s_tb


def _stream(rng, vocab, lens):
    pos, out = 0, []
    for n in lens:
        out.append((rng.integers(0, vocab, n).astype(np.uint32),
                    (pos + np.arange(n)).astype(np.uint32)))
        pos += n
    return out


@pytest.mark.parametrize("seed", range(8))
def test_random_streams_match(seed):
    """Random multi-batch streams over every layout, incl. empty batches,
    pool-cap overflow and (odd seeds) SP start pools."""
    rng = np.random.default_rng(seed)
    li = seed % len(LAYOUTS)
    vocab = int(rng.choice([1, 2, 5, 9]))
    lens = [int(rng.choice([0, 1, 7, 23, 60])) for _ in range(3)]
    nP = len(LAYOUTS[li][0])
    sp = rng.integers(0, nP, vocab) if seed % 2 else None
    run_all(li, vocab, _stream(rng, vocab, lens), sp_per_term=sp)


def test_hot_term_spans_many_slices():
    js, ts = run_all(3, 3, [(np.zeros(500, np.uint32),
                             np.arange(500, dtype=np.uint32))])
    assert int(ts.freq[0]) == 500 and not bool(ts.overflow)


def test_sticky_overflow_same_posting():
    b1 = (np.zeros(18, np.uint32), np.arange(18, dtype=np.uint32))
    b2 = (np.ones(2, np.uint32), np.arange(100, 102, dtype=np.uint32))
    js, ts = run_all(0, 2, [b1, b2])
    assert bool(ts.overflow) and int(ts.freq[0]) == 17
    assert int(ts.freq[1]) == 2


def test_overflow_mid_batch_truncates_per_term():
    rng = np.random.default_rng(7)
    js, ts = run_all(1, 5, [(rng.integers(0, 5, 120).astype(np.uint32),
                             np.arange(120, dtype=np.uint32))])
    assert bool(ts.overflow)


def test_sp_start_pools():
    rng = np.random.default_rng(11)
    run_all(3, 6, _stream(rng, 6, (60, 60, 23)),
            sp_per_term=np.asarray([0, 1, 2, 3, 1, 0]))


def test_recycled_slices_after_release():
    rng = np.random.default_rng(3)
    run_all(2, 5, _stream(rng, 5, (23, 23, 23, 23, 23, 23)),
            release_every=2)


def test_argsort_key_fallback():
    """A vocab too wide to pack (term, index) into 32 key bits takes the
    stable-argsort branch in both packages."""
    vocab = 1 << 24
    rng = np.random.default_rng(13)
    terms = rng.integers(0, vocab, 300).astype(np.uint32)
    terms[::7] = terms[0]
    posts = np.arange(300, dtype=np.uint32)
    run_all(3, vocab, [(terms[:150], posts[:150]),
                       (terms[150:], posts[150:])])


def test_chain_walker_and_materializer_match(small_layout):
    z, spp = small_layout.z, small_layout.slices_per_pool
    tl = tp.PoolLayout(z=z, slices_per_pool=spp)
    vocab = 16
    rng = np.random.default_rng(5)
    terms = rng.integers(0, vocab, 400).astype(np.uint32)
    terms[::3] = 2
    posts = np.arange(400, dtype=np.uint32)
    js = jsp.make_bulk_ingest_fn(small_layout, vocab)(
        jsp.init_state(small_layout, vocab), jnp.asarray(terms),
        jnp.asarray(posts))
    ts = tsp.make_bulk_ingest_fn(tl, vocab, "cpu")(
        tsp.init_state(tl, vocab, "cpu"),
        torch.as_tensor(terms.astype(np.int64)),
        torch.as_tensor(posts.astype(np.int64)))
    max_slices, max_len = 12, 256
    jwalk = jax.jit(jsp.make_chain_walker(small_layout, max_slices))
    jmat = jax.jit(jsp.make_materializer(small_layout, max_slices, max_len))
    twalk = tsp.make_chain_walker(tl, max_slices)
    tmat = tsp.make_materializer(tl, max_slices, max_len)
    tw = twalk(ts, torch.arange(vocab))
    tv, tn = tmat(ts, torch.arange(vocab))
    for t in range(vocab):
        jw = jwalk(js, jnp.uint32(t))
        for a, b in zip(jw, tw):
            np.testing.assert_array_equal(b[t].numpy(),
                                          np.asarray(a, np.int64))
        jv, jn = jmat(js, jnp.uint32(t))
        assert int(jn) == int(tn[t])
        np.testing.assert_array_equal(tv[t].numpy(), np.asarray(jv, np.int64))
    assert tsp.memory_slots_used(tl, ts) == jsp.memory_slots_used(
        small_layout, js)
    assert tsp.memory_high_water_slots(tl, ts) == \
        jsp.memory_high_water_slots(small_layout, js)
    assert tsp.pool_utilization(tl, ts) == jsp.pool_utilization(
        small_layout, js)


def test_release_rejects_double_release():
    tl = tp.PoolLayout(z=(1, 4), slices_per_pool=(8, 3))
    st = tsp.make_bulk_ingest_fn(tl, 2, "cpu")(
        tsp.init_state(tl, 2, "cpu"), torch.zeros(10, dtype=torch.int64),
        torch.arange(10))
    fz = tseg.freeze_state(tl, st.heap, st.tail, st.freq, n_docs=1)
    st = tsp.release_slices(tl, st, fz.freed_slices)
    with pytest.raises(ValueError, match="double release"):
        tsp.release_slices(tl, st, fz.freed_slices)
