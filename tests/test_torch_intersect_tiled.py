"""Port vs reference: the tiled design of the ``intersect_mask`` kernel.

The CUDA kernel finds each row's valid lengths, cuts the merge of the
valid prefixes into merge-path tiles (b first on ties), stages b[j0 - 1]
beside each tile's b elements and marks the a lanes from shared memory.
Here, on the CPU, its plain mirror (``kernels.ref.intersect_mask_tiled_ref``
and the partition ``kernels.ref.intersect_tiles``) is held against the
JAX oracle ``repro.kernels.ref.intersect_mask_ref`` and, at one shape,
the Pallas kernel in interpret mode: tiles of 1, 2, 3, 7 and 64 on the
edge cases every card check of the kernel uses
(``launch.time_intersect_mask.edge_cases``), and a hypothesis property
over random ascending padded pairs.  Integer masks, exact equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import postings_intersect as j_pi
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import postings_intersect as t_pi
from repro_torch.kernels import ref as tref
from repro_torch.launch import time_intersect_mask as tim

INVALID = 0xFFFFFFFF
TILES = [1, 2, 3, 7, 64]
CASES = [name for name, _, _ in tim.edge_cases(4)]


def _case(name, tile):
    return next((a, b) for n, a, b in tim.edge_cases(tile) if n == name)


def _oracle(a, b):
    """The JAX oracle row by row (it takes one list pair)."""
    return np.stack([np.asarray(jref.intersect_mask_ref(
        jnp.asarray(x.astype(np.uint32)), jnp.asarray(y.astype(np.uint32))))
        for x, y in zip(a, b)])


def test_edge_cases_are_ascending_padded_lists():
    for tile in TILES + [t_pi.TILE]:
        cases = tim.edge_cases(tile)
        assert [n for n, _, _ in cases] == CASES
        for name, a, b in cases:
            for x in (a, b):
                assert x.dtype == np.int64 and x.ndim == 2, name
                assert (np.diff(x, axis=1) >= 0).all(), name
                assert ((x >= 0) & (x <= INVALID)).all(), name
            assert a.shape[0] == b.shape[0], name


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", CASES)
def test_tiled_mirror_matches_oracle(name, tile):
    a, b = _case(name, tile)
    got = tref.intersect_mask_tiled_ref(torch.from_numpy(a),
                                        torch.from_numpy(b), tile)
    assert got.dtype == torch.int32 and got.shape == a.shape
    np.testing.assert_array_equal(got.numpy(), _oracle(a, b))
    np.testing.assert_array_equal(
        ops.intersect_mask(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        got.numpy())


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", CASES)
def test_tiles_partition_the_restricted_merge(name, tile):
    """Tiles cover a's valid prefix and b's entries inside a's range in
    order, each holds at most ``tile`` elements, and every boundary
    keeps the merge's order with b first on ties."""
    a, b = _case(name, tile)
    for x, y in zip(a, b):
        na_v, jlo, jhi, tiles = tref.intersect_tiles(torch.from_numpy(x),
                                                     torch.from_numpy(y),
                                                     tile)
        assert na_v == int((x != INVALID).sum())
        if na_v:
            assert jlo == np.searchsorted(y, x[0], "left")
            assert jhi == np.searchsorted(y, x[na_v - 1], "right")
        if na_v == 0 or jhi == jlo:
            assert tiles == []
            continue
        A, B = x[:na_v], y[jlo:jhi]
        i_end = j_end = 0
        for i0, i1, j0, j1 in tiles:
            assert (i0, j0) == (i_end, j_end)
            assert 0 < (i1 - i0) + (j1 - j0) <= tile
            i_end, j_end = i1, j1
            if 0 < i0 < na_v and 0 < j0 < B.size:
                assert B[j0 - 1] <= A[i0] and A[i0 - 1] < B[j0]
        assert (i_end, j_end) == (na_v, B.size)


def test_tiled_mirror_matches_interpret_kernel():
    """The Pallas kernel in interpret mode at one shape: runs of
    duplicates in both lists against tiles of 7."""
    rng = np.random.default_rng(3)
    a = np.full(256, INVALID, np.uint32)
    b = np.full(256, INVALID, np.uint32)
    x = np.sort(rng.integers(0, 90, 180)).astype(np.uint32)
    y = np.sort(rng.integers(0, 90, 150)).astype(np.uint32)
    a[: x.size], b[: y.size] = x, y
    want = np.asarray(j_pi.intersect_mask(jnp.asarray(a), jnp.asarray(b),
                                          ta=128, tb=128, interpret=True))
    got = tref.intersect_mask_tiled_ref(torch.from_numpy(a.astype(np.int64)),
                                        torch.from_numpy(b.astype(np.int64)),
                                        7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bound_counts_what_the_call_needs():
    """a's valid prefix and b's entries inside a's range (8 bytes each)
    only when some b lies there, plus the int32 mask over all of a."""
    a, b = _case("b_past_both_ends", 64)
    need, full = tim.bound_bytes(torch.from_numpy(a), torch.from_numpy(b))
    na_v = int((a != INVALID).sum())
    inside = int(((b >= a[0, 0]) & (b <= a[0, na_v - 1])).sum())
    assert need == 8 * (na_v + inside) + 4 * a.size
    assert full == 8 * (a.size + b.size) + 4 * a.size
    a, b = _case("a_below_b", 64)
    assert tim.bound_bytes(torch.from_numpy(a),
                           torch.from_numpy(b))[0] == 4 * a.size


@st.composite
def _pairs(draw):
    na, nb = draw(st.sampled_from([17, 40])), draw(st.sampled_from([9, 40]))
    span = draw(st.sampled_from([6, 60, 1 << 32]))

    def lst(n):
        k = draw(st.integers(0, n))
        vals = draw(st.lists(st.integers(0, min(span, 1 << 32) - 2),
                             min_size=k, max_size=k))
        out = np.full(n, INVALID, np.int64)
        out[:k] = np.sort(np.asarray(vals, np.int64))
        return out
    return lst(na)[None], lst(nb)[None], draw(st.sampled_from(TILES))


@settings(max_examples=60, deadline=None)
@given(_pairs())
def test_tiled_mirror_property(case):
    a, b, tile = case
    got = tref.intersect_mask_tiled_ref(torch.from_numpy(a),
                                        torch.from_numpy(b), tile)
    np.testing.assert_array_equal(got.numpy(), _oracle(a, b))


def test_tiled_mirror_on_the_sequential_routes_calls(monkeypatch):
    """The (a, b) pairs the engine's ``batched=False`` route really gives
    ``intersect_mask`` (a small stream through four rollovers with 300
    docs left active; AOL-like conjunctions and some of terms that share
    an active doc): the tiled mirror equals the JAX oracle on each, and
    some pairs have hits."""
    from repro.data import synth
    from repro_torch.core import lifecycle as tl
    from repro_torch.core import pointers as tp
    from repro_torch.core import segments as tseg

    from conftest import max_slices_for
    vocab, n_docs, seg, batch = 1500, 2000, 400, 100
    docs = synth.zipf_corpus(synth.CorpusSpec(vocab=vocab, n_docs=n_docs,
                                              seed=3))
    freqs = synth.term_freqs(docs, vocab)
    z = (1, 4, 7, 11)
    eng = tl.LifecycleEngine(
        tp.PoolLayout(z=z, slices_per_pool=(4096, 2048, 1024, 512)), vocab,
        seg, max_slices=max_slices_for(z, freqs),
        max_len=1 << int(freqs.max()).bit_length(), max_query_len=4,
        compaction=tseg.CompactionPolicy(fanout=2), device="cpu")
    for i in range(0, n_docs - batch, batch):   # 300 docs stay active
        eng.ingest(docs[i: i + batch])
    qs = synth.query_log("aol", 12, docs, vocab, seed=4)
    queries = [tuple(int(t) for t in r if t >= 0) for r in qs]
    # and conjunctions of terms that share an active doc, so some hit
    queries += [tuple(int(t) for t in np.unique(docs[d][docs[d] >= 0])[:3])
                for d in range(1650, 1900, 50)]
    calls, real = [], ops.intersect_mask

    def spy(a, b):
        calls.append((a.clone(), b.clone()))
        return real(a, b)
    monkeypatch.setattr(ops, "intersect_mask", spy)
    eng.batched = False
    eng.conjunctive_batch(queries)
    assert sum(int(real(a, b).sum()) > 0 for a, b in calls) > 0
    for a, b in calls:
        a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        want = _oracle(a2.numpy(), b2.numpy())
        for tile in (7, 64):
            got = tref.intersect_mask_tiled_ref(a2, b2, tile)
            np.testing.assert_array_equal(got.numpy(), want)
