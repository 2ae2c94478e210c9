"""Port vs reference: packed slice pointers and postings.

The same numpy-seeded (pool, slice, offset) triples and raw pointers go
through the JAX package's jnp encode/decode and the port's torch
versions (int64 carrying uint32); results must be exactly equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pointers as jp
from repro.core import postings as jpost
from repro_torch.core import pointers as tp
from repro_torch.core import postings as tpost

LAYOUTS = [((1, 4, 7, 11), (4096, 2048, 1024, 512)),
           ((1, 4, 7, 11), (1 << 21, 1 << 21, 1 << 19, 1 << 17)),
           ((0, 2, 5), (16, 6, 2)),
           ((3,), (12,))]


def _both(z, spp):
    return jp.PoolLayout(z=z, slices_per_pool=spp), tp.PoolLayout(
        z=z, slices_per_pool=spp)


@pytest.mark.parametrize("z,spp", LAYOUTS)
def test_layout_properties_match(z, spp):
    jl, tl = _both(z, spp)
    for name in ("num_pools", "pool_bits", "slice_sizes", "slice_bits",
                 "pool_slots", "pool_base", "total_slots", "total_slices",
                 "free_base"):
        assert getattr(jl, name) == getattr(tl, name), name
    assert [jl.max_slices(p) for p in range(jl.num_pools)] == \
        [tl.max_slices(p) for p in range(tl.num_pools)]


@pytest.mark.parametrize("z,spp", LAYOUTS)
def test_encode_decode_match(z, spp):
    jl, tl = _both(z, spp)
    rng = np.random.default_rng(sum(spp))
    n = 500
    pool = rng.integers(0, jl.num_pools, n)
    sl = np.asarray([rng.integers(0, spp[p]) for p in pool])
    off = np.asarray([rng.integers(0, 1 << z[p]) for p in pool])
    jt, tt = jl.tables(), tl.tables("cpu")
    want = np.asarray(jp.encode(jt, jl.pool_bits, jnp.asarray(pool, jnp.uint32),
                                jnp.asarray(sl, jnp.uint32),
                                jnp.asarray(off, jnp.uint32)))
    got = tp.encode(tt, tl.pool_bits, torch.as_tensor(pool),
                    torch.as_tensor(sl), torch.as_tensor(off)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # decode every encoded pointer, random words and NULL
    ptrs = np.concatenate([want, rng.integers(0, 1 << 32, n,
                                              dtype=np.uint64)
                           .astype(np.uint32), [jp.NULL]])
    jd = jp.decode(jt, jl.pool_bits, jnp.asarray(ptrs))
    td = tp.decode(tt, tl.pool_bits, torch.as_tensor(ptrs.astype(np.int64)))
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a, np.int64))
    ja = jp.ptr_to_addr(jt, jl.pool_bits, jnp.asarray(ptrs))
    ta = tp.ptr_to_addr(tt, tl.pool_bits,
                        torch.as_tensor(ptrs.astype(np.int64)))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja, np.int64))
    for p, s, o in zip(pool[:50], sl[:50], off[:50]):
        h = tp.encode_host(tl, int(p), int(s), int(o))
        assert h == jp.encode_host(jl, int(p), int(s), int(o))
        assert tp.decode_host(tl, h) == jp.decode_host(jl, h)


@pytest.mark.parametrize("z,spp", [((), ()), ((4, 4), (1, 1)),
                                   ((1, 2), (1,)), ((1, 31), (1, 1)),
                                   ((1, 4), (1 << 31, 1))])
def test_layout_errors_match(z, spp):
    with pytest.raises(ValueError) as je:
        jp.PoolLayout(z=z, slices_per_pool=spp)
    with pytest.raises(ValueError) as te:
        tp.PoolLayout(z=z, slices_per_pool=spp)
    assert str(je.value) == str(te.value)


def test_production_layout_matches():
    assert jp.production_layout() == jp.PoolLayout(
        **vars(tp.production_layout()))


def test_postings_pack_match():
    rng = np.random.default_rng(4)
    doc = rng.integers(0, 1 << 25, 1000)          # includes >24-bit wrap
    pos = rng.integers(0, 300, 1000)
    want = np.asarray(jpost.pack(jnp.asarray(doc, jnp.uint32),
                                 jnp.asarray(pos, jnp.uint32)))
    got = tpost.pack(torch.as_tensor(doc), torch.as_tensor(pos)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(
        tpost.docid(torch.as_tensor(got)).numpy(),
        np.asarray(jpost.docid(jnp.asarray(want)), np.int64))
    np.testing.assert_array_equal(
        tpost.position(torch.as_tensor(got)).numpy(),
        np.asarray(jpost.position(jnp.asarray(want)), np.int64))
