"""The bulk_append kernel's launch plan, its walk and its precondition, on
the CPU.

``kernels.bulk_append.launch_plan`` picks the CUDA kernel's lanes a
thread, grid and alignment bits from the lane count, the SM count and the
seven streams' addresses.  :func:`walk` follows the kernel's own index
formulas (warp tiles grid-stride, a thread's lane pairs ``64p + 2t`` and
``64p + 2t + 1`` of its tile) and must visit every lane below ``n``
exactly once; the plan must be one wave and claim a two-lane load only
on a stream whose base allows it.

:func:`mirror` applies a call as the kernel does (lanes past ``n`` read
the skip address -1, a warp's vote per stream, stores only where a lane
lands) in numpy; on the edge cases of ``launch/time_bulk_append.py`` it
must equal ``bulk_append_ref`` bit for bit.

The kernel writes with plain stores because the plan makes every live
address unique: over seeded and hypothesis-drawn batches of padded
tweets (``make_bulk_ingest_fn(..., device="cpu")``, free-list pops after
a release, overflowing pools), every live heap address (postings and
pointers together) and every live term index is unique, every skip
lane's address is out of range and distinct, and every lane past the
valid prefix skips in all three streams.  The seeded streams, planned by
the port and applied by :func:`mirror`, must give the JAX package's bulk
ingest state bit for bit.  No tolerance: everything here is integers.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import pointers as jp
from repro.core import segments as jseg
from repro.core import slicepool as jsp
from repro_torch.core import convert
from repro_torch.core import pointers as tp
from repro_torch.core import segments as tseg
from repro_torch.core import slicepool as tsp
from repro_torch.core.index import flatten
from repro_torch.kernels import bulk_append as kba
from repro_torch.kernels import ref
from repro_torch.launch import time_bulk_append as tba

H100_SMS = 132
BASE = 1 << 21                  # a data_ptr aligned to 16 bytes
ALIGNMENTS = {"16-byte": (BASE,) * 7,
              "8-byte only": (BASE + 8,) * 6 + (BASE + 4,)}


def walk(plan, n: int) -> np.ndarray:
    """The lane index of every (tile, pair, thread, lane of the pair) the
    kernel visits, a row a tile (sorted by tile): warp k of CTA b takes
    tiles k x grid + b, then W (the grid's warps) further, ... below the
    kernel's tile count;
    thread t holds lanes ``64p + 2t`` and ``64p + 2t + 1`` of a tile.
    Entries ``>= n`` are the lanes the kernel reads as skips."""
    pairs = plan.lanes_per_thread // 2
    tile = 64 * pairs
    tiles = -(-n // tile)
    assert (plan.tile, plan.tiles) == (tile, tiles)
    per_cta = plan.threads // 32
    warps = plan.grid * per_cta
    # warp k of CTA b starts at tile k * grid + b and strides by W
    first = (np.arange(per_cta)[None, :] * plan.grid
             + np.arange(plan.grid)[:, None]).ravel()
    w = (first[None, :] + warps * np.arange(-(-tiles // warps))[:, None])
    w = np.sort(w[w < tiles])
    at = (w[:, None, None] * tile + 64 * np.arange(pairs)[None, :, None]
          + 2 * np.arange(32)[None, None, :])
    return np.stack([at, at + 1], -1).reshape(len(w), tile)


def _plan_for(scat, sms=H100_SMS):
    return kba.launch_plan(scat[0].shape[0], sms,
                           [t.data_ptr() for t in scat])


def mirror(plan, state, scat):
    """``(heap, tail, freq)`` after the kernel's walk of ``plan`` over the
    seven streams, from numpy copies of ``state``."""
    heap, tail, freq = (t.numpy().copy() for t in state)
    s = [t.numpy() for t in scat]
    n = len(s[0])
    lanes = walk(plan, n)                      # [tiles, tile]
    inside = lanes < n
    at = np.where(inside, lanes, 0)

    def addrs(a):
        return np.where(inside, a[at], -1)
    pa, qa, ta = addrs(s[0]), addrs(s[2]), addrs(s[4])
    live = [(pa >= 0) & (pa < len(heap)), (qa >= 0) & (qa < len(heap)),
            (ta >= 0) & (ta < len(tail))]
    # a warp's vote: a tile with no landing lane loads no value
    vote = [m.any(1, keepdims=True) & m for m in live]
    heap[pa[vote[0]]] = s[1][at[vote[0]]]
    heap[qa[vote[1]]] = s[3][at[vote[1]]]
    tail[ta[vote[2]]] = s[5][at[vote[2]]]
    freq[ta[vote[2]]] = s[6][at[vote[2]]]
    return heap, tail, freq


# -- the launch plan ---------------------------------------------------------
@pytest.mark.parametrize("align", sorted(ALIGNMENTS))
@pytest.mark.parametrize("n", tba.edge_lengths(H100_SMS))
def test_plan_covers_every_lane_once(n, align):
    ptrs = ALIGNMENTS[align]
    for sms in (1, H100_SMS):
        p = kba.launch_plan(n, sms, ptrs)
        assert (p.lanes_per_thread, p.threads) == (kba.LANES, kba.THREADS)
        assert 1 <= p.grid <= kba.CTAS_PER_SM * sms
        lanes = walk(p, n).ravel()
        counts = np.bincount(lanes[lanes < n], minlength=n)
        assert (counts == 1).all(), (n, sms, p)
        # every warp has a tile when the tiles fill the grid
        assert p.grid == min(-(-p.tiles // kba.WARPS),
                             kba.CTAS_PER_SM * sms)
        assert p.aligned == (127 if align == "16-byte" else 0)


@pytest.mark.parametrize("n, grid", [(286_720, 560), (71_680, 140)])
def test_path_batches_fit_one_wave(n, grid):
    """Phase 2's batch (and so phase 3's) and a shard's batch at 8a take
    one wave on 132 SMs, a warp a tile."""
    p = kba.launch_plan(n, H100_SMS, ALIGNMENTS["16-byte"])
    assert p.grid == grid <= kba.CTAS_PER_SM * H100_SMS
    assert p.grid * kba.WARPS * p.tile >= n


def test_plan_alignment_bits_per_stream():
    """A stream takes two lanes a load only where its base is aligned to
    two elements: 16 bytes for the int64 streams, 8 for the int32
    ``term_freq``."""
    for k in range(7):
        for off, want in ((0, 1), (8, 0), (16, 1), (24, 0)):
            ptrs = [BASE] * 7
            ptrs[k] += off if k < 6 else off // 2
            got = kba.launch_plan(1000, H100_SMS, ptrs).aligned
            assert got == 127 ^ ((1 - want) << k)


def test_plan_from_views_at_storage_offset_1():
    """On tensors: a view one element into its storage loses the bit of
    its stream, the others keep theirs."""
    n = 1000
    streams = [torch.zeros(n + 1, dtype=torch.int64) for _ in range(6)] + [
        torch.zeros(n + 1, dtype=torch.int32)]
    views = [t[1:] if k % 2 == 0 else t[:n] for k, t in enumerate(streams)]
    bits = _plan_for(views).aligned
    assert all(t.data_ptr() % 64 == 0 for t in streams)
    assert bits == sum(1 << k for k in range(7) if k % 2 == 1)


def test_plan_rejects_bad_arguments():
    with pytest.raises(ValueError, match="n must be"):
        kba.launch_plan(0, H100_SMS, ALIGNMENTS["16-byte"])
    with pytest.raises(ValueError, match="stream addresses"):
        kba.launch_plan(5, H100_SMS, (BASE,) * 6)


# -- the kernel's walk on the edge cases -------------------------------------
# made at first use (about 250 MB), not when a worker collects the file
N_EDGE = len(tba.edge_lengths(H100_SMS)) + 6


@functools.lru_cache(maxsize=1)
def _edge():
    return (tba.edge_cases(H100_SMS, device="cpu"),
            tba.edge_state(device="cpu"))


def test_edge_case_count():
    assert len(_edge()[0]) == N_EDGE


@pytest.mark.parametrize("case", range(N_EDGE))
def test_mirror_equals_plain_version_on_edge_cases(case):
    cases, state = _edge()
    name, scat = cases[case]
    want = ref.bulk_append_ref(*[t.clone() for t in state], *scat)
    got = mirror(_plan_for(scat), state, scat)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)


def test_edge_cases_cover_what_they_name():
    names = dict(_edge()[0])
    H, V = tba.EDGE_H, tba.EDGE_V
    extreme = names["addresses -1, H - 1, H, 2**40, V - 1 and V"]
    assert {-1, H - 1, H, 1 << 40} <= set(extreme[0].tolist())
    assert {V - 1, V} <= set(extreme[4].tolist())
    assert _plan_for(names["all seven streams at storage offset 1"]
                     ).aligned == 0
    live = tba.landing(names["every lane skips"], H, V)
    assert not any(bool(m.any()) for m in live)
    live = tba.landing(names["every lane lands"], H, V)
    assert all(bool(m.all()) for m in live)


# -- the plan's precondition: unique live addresses --------------------------
def check_precondition(scat, H: int, V: int, n_valid: int) -> list:
    """The bulk allocator's promise that lets the kernel store without
    atomics; returns the three landing masks."""
    s = [t.numpy() for t in scat]
    n = len(s[0])
    live = [(s[0] >= 0) & (s[0] < H), (s[2] >= 0) & (s[2] < H),
            (s[4] >= 0) & (s[4] < V)]
    heap_live = np.concatenate([s[0][live[0]], s[2][live[1]]])
    assert np.unique(heap_live).size == heap_live.size
    assert np.unique(s[4][live[2]]).size == int(live[2].sum())
    for a, m, cap in ((s[0], live[0], H), (s[2], live[1], H),
                      (s[4], live[2], V)):
        assert (a[~m] >= cap).all()            # skips are out of range
        assert np.unique(a).size == n           # ... and distinct
    # pads sort last: every lane past the valid prefix skips everywhere
    assert not (live[0] | live[1] | live[2])[n_valid:].any()
    return live


def _tweets(rng, batch: int, L: int, vocab: int, hot: float = 0.0):
    """int32[batch, L] tweets padded with -1 (lengths 0..L), a share
    ``hot`` of the terms being term 0."""
    lens = rng.integers(0, L + 1, batch)
    terms = rng.integers(0, vocab, (batch, L))
    terms[rng.random((batch, L)) < hot] = 0
    return np.where(np.arange(L)[None, :] < lens[:, None], terms,
                    -1).astype(np.int32)


def run_stream(z, spp, vocab: int, batches, release_every=0, jax_too=True):
    """Plan each batch with the port, check the precondition, apply it by
    :func:`mirror` (equal to the plain version), and (``jax_too``) hold
    the state against the JAX
    package's bulk ingest of the same batch; release the segment's slices
    every ``release_every`` batches.  Returns the port's final state and
    the free lists' pops seen."""
    tl = tp.PoolLayout(z=z, slices_per_pool=spp)
    ingest = tsp.make_bulk_ingest_fn(tl, vocab, "cpu")
    state = tsp.init_state(tl, vocab, "cpu")
    if jax_too:
        jl = jp.PoolLayout(z=z, slices_per_pool=spp)
        j_ingest = jsp.make_bulk_ingest_fn(jl, vocab)
        j_state = jsp.init_state(jl, vocab)
    pops, next_doc = 0, 0
    for bi, docs in enumerate(batches):
        terms, plist, valid = flatten(torch.as_tensor(docs), next_doc)
        next_doc += docs.shape[0]
        scat, wm, fc, ovf = ingest.plan(state, terms, plist,
                                        torch.zeros_like(terms), valid)
        check_precondition(scat, tl.total_slots, vocab, int(valid.sum()))
        pops += int((state.free_count - fc).clamp(min=0).sum())
        heap, tail, freq = mirror(_plan_for(scat), (state.heap, state.tail,
                                                    state.freq), scat)
        want = ref.bulk_append_ref(state.heap.clone(), state.tail.clone(),
                                   state.freq.clone(), *scat)
        for g, w in zip((heap, tail, freq), want):
            np.testing.assert_array_equal(g, w.numpy())
        state = tsp.PoolState(torch.as_tensor(heap), wm,
                              torch.as_tensor(tail), torch.as_tensor(freq),
                              ovf, state.free_list, fc)
        if jax_too:
            j_state = j_ingest(j_state, jnp.asarray(terms.numpy(), jnp.uint32),
                               jnp.asarray(plist.numpy(), jnp.uint32),
                               None, jnp.asarray(valid.numpy()))
            want = {f: np.asarray(getattr(j_state, f))
                    for f in jsp.PoolState._fields}
            got = convert.pool_state_to_numpy(state)
            for f in want:
                np.testing.assert_array_equal(got[f], want[f],
                                              err_msg=f"batch {bi}: {f}")
        if release_every and (bi + 1) % release_every == 0 \
                and not bool(state.overflow):
            fz = tseg.freeze_state(tl, state.heap, state.tail, state.freq,
                                   n_docs=1)
            state = tsp.release_slices(tl, state, fz.freed_slices)
            if jax_too:
                jfz = jseg.freeze_state(jl, np.asarray(j_state.heap),
                                        np.asarray(j_state.tail),
                                        np.asarray(j_state.freq), n_docs=1)
                j_state = jsp.release_slices(jl, j_state, jfz.freed_slices)
    return state, pops


# (name, z, slices a pool, vocab, batches, tweets a batch, max terms,
#  hot-term share, release every)
STREAMS = [
    ("production pools", (1, 4, 7, 11), (64, 32, 16, 8), 16, 3, 24, 8, 0.0,
     0),
    ("a hot term across pools", (1, 4, 7, 11), (256, 64, 32, 16), 9, 2, 40,
     12, 0.6, 0),
    ("release, then pops", (0, 2, 5), (16, 6, 2), 5, 6, 6, 4, 0.0, 2),
    ("overflow", (1, 4), (8, 3), 9, 3, 20, 6, 0.3, 0),
    ("one pool", (3,), (12,), 7, 3, 5, 5, 0.0, 0),
]


@pytest.mark.parametrize("name, z, spp, vocab, nb, batch, L, hot, rel",
                         STREAMS, ids=[s[0] for s in STREAMS])
def test_plan_precondition_and_mirror_match_jax(name, z, spp, vocab, nb,
                                                batch, L, hot, rel):
    rng = np.random.default_rng(sum(map(ord, name)))
    batches = [_tweets(rng, batch, L, vocab, hot) for _ in range(nb)]
    state, pops = run_stream(z, spp, vocab, batches, release_every=rel)
    if name == "overflow":
        assert bool(state.overflow)
    if rel:
        assert pops > 0, "no batch popped a free list"


@settings(max_examples=30, deadline=None)
@given(layout=st.sampled_from([s[1:3] for s in STREAMS]),
       vocab=st.integers(1, 40), nb=st.integers(1, 5),
       batch=st.integers(1, 24), L=st.integers(1, 12),
       hot=st.sampled_from([0.0, 0.5, 0.9]), rel=st.integers(0, 2),
       seed=st.integers(0, 2**32 - 1))
def test_plan_precondition_holds_on_drawn_batches(layout, vocab, nb, batch,
                                                  L, hot, rel, seed):
    """The precondition on drawn streams (the mirror against the plain
    version, no JAX: each shape would compile anew)."""
    rng = np.random.default_rng(seed)
    batches = [_tweets(rng, batch, L, vocab, hot) for _ in range(nb)]
    # a one-pool layout has no previous-pointer slot, so its chains
    # cannot be frozen past one slice: release only with several pools
    state, _ = run_stream(*layout, vocab, batches,
                          release_every=rel if len(layout[0]) > 1 else 0,
                          jax_too=False)
    # no term counts more postings than the batches held (each landed at
    # most once)
    assert int(state.freq.sum()) <= sum(int((b >= 0).sum()) for b in batches)
