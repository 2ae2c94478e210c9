"""Port vs reference: the document-sharded index's building blocks.

The shard merges and docid translation against the JAX functions
(hypothesis properties of ``tests/test_sharded_index.py``); the S = 1
engine against the unsharded one; for S = 2 and S = 4, shard s's
allocator state after every arrival batch against the JAX single-device
bulk ingest of the residue substream ``docs[s::S]`` (the in-place writes
through each shard's row views must land); the ``ForBlocks`` codec and
``compress_segment`` byte for byte; and the stacked-state memory
gauges.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import segments as jseg
from repro.core import sharded_index as jsh
from repro.core import slicepool as jsp
from repro.core.index import ActiveSegment as JActive
from repro.core.pointers import PoolLayout as JLayout
from repro.data import synth
from repro_torch.core import convert
from repro_torch.core import segments as tseg
from repro_torch.core import sharded_index as tsh
from repro_torch.core import slicepool as tsp
from repro_torch.core.index import ActiveSegment as TActive
from repro_torch.core.pointers import PoolLayout as TLayout
from repro_torch.core.query import make_engine
from repro_torch.dist import collectives as coll

INVALID = 0xFFFFFFFF
Z, SPP = (1, 4, 7, 11), (1024, 512, 128, 32)
ids = st.lists(st.integers(0, 500), min_size=0, max_size=60)


def _shard_desc(xs, S, W):
    """[S, W] descending INVALID-padded lists of each residue class."""
    out = np.full((S, W), INVALID, np.uint32)
    ns = np.zeros(S, np.int32)
    for s in range(S):
        mine = sorted({x for x in xs if x % S == s}, reverse=True)
        out[s, : len(mine)] = mine
        ns[s] = len(mine)
    return out, ns


@given(ids, st.sampled_from([2, 4]), st.sampled_from([None, 1, 5]))
@settings(max_examples=40, deadline=None)
def test_topk_merge_matches_reference(xs, S, k):
    lists, ns = _shard_desc(xs, S, 64)
    want, wn = jsh.topk_merge_desc(jnp.asarray(lists), jnp.asarray(ns), k=k)
    got, gn = tsh.topk_merge_desc(torch.from_numpy(lists.astype(np.int64)),
                                  torch.from_numpy(ns), k=k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(gn) == int(wn) == len(sorted(set(xs))[: k or None])


@given(ids)
@settings(max_examples=30, deadline=None)
def test_merge_desc_scored_keeps_lanes_with_their_docids(xs):
    lists, _ = _shard_desc(xs, 4, 32)
    flat = lists.reshape(-1)
    scores = (flat.astype(np.int64) % 7).astype(np.int32)
    wi, ws = jsh.merge_desc_scored(jnp.asarray(flat), jnp.asarray(scores))
    gi, gs = tsh.merge_desc_scored(torch.from_numpy(flat.astype(np.int64)),
                                   torch.from_numpy(scores))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_local_to_global_preserves_order_and_padding():
    local = [0, 1, 5, 9, INVALID, INVALID]
    want = np.asarray(jsh.local_to_global(jnp.asarray(local, jnp.uint32),
                                          shard=3, n_shards=4))
    got = tsh.local_to_global(torch.tensor(local), shard=3, n_shards=4)
    assert got.tolist() == want.tolist() == [3, 7, 23, 39, INVALID, INVALID]
    for f in (1, 2, 7, 8, 9, 1000):
        assert tsh.engine_max_len(f) == jsh.engine_max_len(f)


def test_mesh_and_collectives():
    mesh = tsh.make_doc_mesh(4, device="cpu")
    assert mesh.num_shards == 4 and mesh.device == torch.device("cpu")
    assert tsh.ShardedActiveSegment(TLayout(z=Z, slices_per_pool=SPP), 10,
                                    mesh).state.heap.shape[0] == 4
    with pytest.raises(ValueError, match="at least one shard"):
        tsh.make_doc_mesh(0, device="cpu")
    x = torch.arange(24).reshape(4, 2, 3)          # [S, Q, W]
    assert coll.all_gather(x, axis=1).tolist() == \
        torch.cat(list(x), 1).tolist()
    assert coll.psum(x).tolist() == x.sum(0).tolist()


def _stream(n_docs, seed, vocab=300):
    spec = synth.CorpusSpec(vocab=vocab, n_docs=n_docs, seed=seed)
    return synth.zipf_corpus(spec)


@pytest.mark.parametrize("S", [2, 4])
def test_shard_state_equals_reference_ingest_of_its_residue_stream(S):
    """After every batch, shard s of the stacked state equals the JAX
    single-device bulk ingest of ``docs[s::S]``: the bulk allocator's
    in-place writes through each shard's row views land in the stacked
    tensors, shard by shard."""
    docs = _stream(480, seed=5)
    seg = tsh.ShardedActiveSegment(TLayout(z=Z, slices_per_pool=SPP), 300,
                                   tsh.make_doc_mesh(S, device="cpu"))
    refs = [JActive(JLayout(z=Z, slices_per_pool=SPP), 300)
            for _ in range(S)]
    for i in range(0, 480, 80):
        seg.ingest(docs[i: i + 80])
        got = convert.pool_state_to_numpy(seg.state)
        for s, ref in enumerate(refs):
            ref.ingest(jnp.asarray(docs[i: i + 80][s::S]))
            for f in jsp.PoolState._fields:
                want = np.asarray(getattr(ref.state, f))
                np.testing.assert_array_equal(got[f][s], want,
                                              err_msg=f"batch {i}: {f}")
    assert seg.next_docid == 480
    np.testing.assert_array_equal(
        seg.term_freqs(), sum(np.asarray(r.state.freq) for r in refs))
    live = [int(jsp.memory_slots_used(r.layout, r.state)) for r in refs]
    np.testing.assert_array_equal(seg.shard_slots_used(), live)
    assert seg.memory_slots_used() == sum(live)
    assert tsp.memory_high_water_slots(seg.layout, seg.state) == sum(
        int(jsp.memory_high_water_slots(r.layout, r.state)) for r in refs)
    assert tsp.pool_utilization(seg.layout, seg.state) == max(
        jsp.pool_utilization(r.layout, r.state) for r in refs)
    with pytest.raises(ValueError, match="multiple of"):
        seg.ingest(docs[:S + 1])
    seg.check_health()


def test_sharded_release_matches_reference():
    """Rollover's reclaim on a stacked state: one freed list per shard,
    the same free lists and counts as the reference's."""
    docs = _stream(160, seed=8)
    S = 4
    seg = tsh.ShardedActiveSegment(TLayout(z=Z, slices_per_pool=SPP), 300,
                                   tsh.make_doc_mesh(S, device="cpu"))
    seg.ingest(docs)
    j_state = convert.pool_state_to_numpy(seg.state)
    freed = [tseg.freeze_state(seg.layout, seg.state.heap[s],
                               seg.state.tail[s], seg.state.freq[s],
                               n_docs=40).freed_slices for s in range(S)]
    got = tsp.release_slices(seg.layout, seg.state, freed)
    want = jsp.release_slices(
        JLayout(z=Z, slices_per_pool=SPP),
        jsp.PoolState(**{f: jnp.asarray(v) for f, v in j_state.items()}),
        freed)
    got = convert.pool_state_to_numpy(got)
    for f in jsp.PoolState._fields:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)))
    with pytest.raises(ValueError, match="freed lists"):
        tsp.release_slices(seg.layout, seg.state, freed[:2])


def test_one_shard_matches_unsharded_segment():
    """S = 1: the sharded shell is a no-op wrapper around the plain
    ActiveSegment and engine."""
    docs = _stream(200, seed=3, vocab=500)
    layout = TLayout(z=Z, slices_per_pool=(2048, 1024, 512, 256))
    plain = TActive(layout, 500, device="cpu")
    sharded = tsh.ShardedActiveSegment(layout, 500,
                                       tsh.make_doc_mesh(1, device="cpu"))
    for i in range(0, 200, 50):
        plain.ingest(docs[i: i + 50])
        sharded.ingest(docs[i: i + 50])
    for f, leaf in zip(tsp.PoolState._fields, plain.state):
        assert torch.equal(getattr(sharded.state, f)[0], leaf), f
    freqs = synth.term_freqs(docs, 500)
    max_len = tsh.engine_max_len(int(freqs.max()))
    eng = make_engine(layout, 64, max_len, 4, use_kernel=True)
    sheng = tsh.make_sharded_engine(layout, sharded.mesh, 64, max_len, 4)
    top = [int(t) for t in np.argsort(-freqs)[:6]]
    terms = torch.tensor([top[:2] + [0, 0], top[2:5] + [0],
                          [top[5]] + [0] * 3])
    n_terms = torch.tensor([2, 3, 1], dtype=torch.int32)
    for kind in ("conjunctive", "disjunctive"):
        want, wn = getattr(eng, kind)(plain.state, terms, n_terms)
        got, gn = getattr(sheng, kind)(sharded.state, terms, n_terms)
        assert torch.equal(gn, wn)
        for r in range(3):
            assert torch.equal(got[r, : int(gn[r])], want[r, : int(wn[r])])
    want, wn = eng.phrase(plain.state, terms[:, 0], terms[:, 1])
    got, gn = sheng.phrase(sharded.state, terms[:, 0], terms[:, 1])
    assert torch.equal(gn, wn) and torch.equal(got, want)
    want, wn = eng.topk_conjunctive(plain.state, terms, n_terms, 3)
    got, gn = sheng.topk_conjunctive(sharded.state, terms, n_terms, 3)
    assert torch.equal(gn, wn)
    for r in range(3):
        assert torch.equal(got[r, : int(gn[r])], want[r, : int(wn[r])])
    want, wsc, wn = eng.conjunctive_scored_asc(plain.state, terms, n_terms)
    got, gsc, gn = sheng.conjunctive_scored(sharded.state, terms, n_terms)
    assert torch.equal(gn, wn)
    for r in range(3):
        n = int(wn[r])
        assert torch.equal(got[r, :n], want[r, :n].flip(0))
        assert torch.equal(gsc[r, :n], wsc[r, :n].flip(0))


def test_for_blocks_and_compress_segment_match_reference():
    rng = np.random.default_rng(0)
    for n in (0, 1, 127, 128, 129, 700):
        vals = np.cumsum(rng.integers(0, 1 << rng.integers(1, 20), n))
        a = tseg.ForBlocks.encode(vals)
        b = jseg.ForBlocks.encode(vals)
        for f in ("widths", "firsts", "payload"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.n == b.n and a.compressed_bytes == b.compressed_bytes
        np.testing.assert_array_equal(a.decode(), vals.astype(np.uint64))
    docs = _stream(120, seed=2)
    seg = TActive(TLayout(z=Z, slices_per_pool=SPP), 300, device="cpu")
    seg.ingest(docs)
    fz = tseg.freeze(seg)
    got, got_bytes = tseg.compress_segment(fz)
    want, want_bytes = jseg.compress_segment(jseg.FrozenSegment(
        offsets=fz.offsets, data=fz.data, n_docs=fz.n_docs))
    assert got_bytes == want_bytes > 0
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.payload.tobytes() == b.payload.tobytes()
