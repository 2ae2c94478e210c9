"""Port vs reference: the embedding-bag kernel's plain version.

The port's ``ops.embedding_bag`` on CPU tensors runs its plain torch
version (``kernels.ref.embedding_bag_ref``), which the CUDA kernel is
held against on the card.  Here it is held against the JAX package's
oracle ``repro.kernels.ref.embedding_bag_ref`` and against the Pallas
kernel in interpret mode, on the same numpy inputs.

Tolerance: rtol = atol = 1e-5 in fp32 (sums of up to 64 rows taken in
another order); bags of one row are exact.  An fp32 table is the case
where all three agree.  For a bf16 table the port follows the Pallas
kernel (rows widened to fp32, an fp32 sum and result), which is a
stated difference from the JAX oracle (a bf16 sum, a bf16 result).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import recsys as JR
from repro_torch.kernels import ops as tops
from repro_torch.models import recsys as TR

TOL = dict(rtol=1e-5, atol=1e-5)


def _bags(rng, R, D, lens, lo=None, hi=None):
    offsets = np.zeros(len(lens) + 1, np.int32)
    offsets[1:] = np.cumsum(lens)
    n = int(offsets[-1])
    idx = rng.integers(0 if lo is None else lo, R if hi is None else hi,
                       n).astype(np.int32)
    table = rng.normal(size=(R, D)).astype(np.float32)
    return table, idx, offsets


def _port(table, idx, offsets, mode):
    out = tops.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                             torch.from_numpy(offsets), mode)
    assert out.dtype == torch.float32
    return out.numpy()


def _jax(table, idx, offsets, mode, pallas):
    args = (jnp.asarray(table), jnp.asarray(idx), jnp.asarray(offsets))
    if pallas:
        return np.asarray(jops.embedding_bag(*args, mode=mode,
                                             interpret=True))
    return np.asarray(jref.embedding_bag_ref(*args, mode=mode))


# the shapes of tests/test_kernels.py's embedding-bag case, plus D = 1
# and the widths of the four recsys configs
@pytest.mark.parametrize("R,D,B,max_bag", [
    (128, 16, 4, 5), (1000, 32, 8, 12), (64, 128, 3, 3), (300, 1, 9, 39),
    (500, 10, 7, 64), (200, 18, 5, 20),
])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_matches_oracle_and_pallas_kernel(R, D, B, max_bag, mode):
    rng = np.random.default_rng(R * 1000 + D)
    lens = rng.integers(0, max_bag + 1, B)
    lens[0] = 0                                   # an empty bag
    args = _bags(rng, R, D, lens)
    got = _port(*args, mode)
    assert got.shape == (B, D)
    np.testing.assert_allclose(got, _jax(*args, mode, pallas=False), **TOL)
    np.testing.assert_allclose(got, _jax(*args, mode, pallas=True), **TOL)
    assert not got[0].any()


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_single_row_bags_are_exact(mode):
    """Bags of one row (every one-id-per-field lookup) equal the row."""
    rng = np.random.default_rng(1)
    table, idx, offsets = _bags(rng, 400, 16, np.ones(50, np.int64))
    got = _port(table, idx, offsets, mode)
    np.testing.assert_array_equal(got, table[idx])
    np.testing.assert_array_equal(got, _jax(table, idx, offsets, mode,
                                            pallas=False))
    np.testing.assert_array_equal(got, _jax(table, idx, offsets, mode,
                                            pallas=True))


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("n_bags", [0, 6])
def test_all_empty_bags_and_no_indices(mode, n_bags):
    """N = 0: every bag is empty and comes out 0 (a mean divides by 1);
    with no bags at all the result is [0, D]."""
    rng = np.random.default_rng(2)
    table, idx, offsets = _bags(rng, 64, 10, np.zeros(n_bags, np.int64))
    assert idx.size == 0
    got = _port(table, idx, offsets, mode)
    assert got.shape == (n_bags, 10) and not got.any()
    if n_bags:
        np.testing.assert_array_equal(got, _jax(table, idx, offsets, mode,
                                                pallas=False))
        np.testing.assert_array_equal(got, _jax(table, idx, offsets, mode,
                                                pallas=True))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_out_of_range_ids_clip(mode):
    """Ids below 0 read row 0 and ids past R read row R - 1, as the
    oracle's ``mode="clip"`` (the TPU kernel itself would read out of
    range, so only the oracle is compared here)."""
    rng = np.random.default_rng(3)
    R = 50
    table, idx, offsets = _bags(rng, R, 16, rng.integers(1, 9, 12),
                                lo=-20, hi=R + 20)
    assert (idx < 0).any() and (idx >= R).any()
    got = _port(table, idx, offsets, mode)
    np.testing.assert_allclose(got, _jax(table, idx, offsets, mode,
                                         pallas=False), **TOL)
    clipped = _port(table, np.clip(idx, 0, R - 1), offsets, mode)
    np.testing.assert_array_equal(got, clipped)


def test_bf16_table_sums_in_fp32_unlike_the_oracle():
    """A bf16 table: the port returns fp32, the fp32 sum of the widened
    rows, as the Pallas kernel does; the JAX oracle returns bf16 summed
    in bf16, so it agrees only to bf16 rounding (a stated difference)."""
    rng = np.random.default_rng(4)
    table, idx, offsets = _bags(rng, 256, 32, rng.integers(0, 40, 16))
    t16 = table.astype(ml_dtypes.bfloat16)
    widened = t16.astype(np.float32)
    got = tops.embedding_bag(torch.from_numpy(widened).bfloat16(),
                             torch.from_numpy(idx),
                             torch.from_numpy(offsets)).numpy()
    want = _port(widened, idx, offsets, "sum")
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(jops.embedding_bag(
        jnp.asarray(t16), jnp.asarray(idx), jnp.asarray(offsets),
        interpret=True))
    assert pallas.dtype == np.float32
    np.testing.assert_allclose(got, pallas, **TOL)
    oracle = jref.embedding_bag_ref(jnp.asarray(t16), jnp.asarray(idx),
                                    jnp.asarray(offsets))
    assert oracle.dtype == jnp.bfloat16
    oracle = np.asarray(oracle.astype(jnp.float32))
    assert not np.array_equal(got, oracle)
    # bf16 keeps 8 bits: each of up to 40 partial sums rounds by 2**-8
    scale = np.abs(widened).max() * 40
    np.testing.assert_allclose(got, oracle, rtol=0, atol=scale * 2 ** -7)


def test_model_substrate_bag_matches_reference():
    """The models' multi-hot ``embedding_bag`` (indices + per-index bag
    ids, any order) against the reference's take + segment_sum."""
    rng = np.random.default_rng(5)
    R, D, B, n = 256, 64, 6, 40
    table = rng.normal(size=(R, D)).astype(np.float32)
    idx = rng.integers(0, R, n).astype(np.int32)
    seg = rng.integers(0, B, n).astype(np.int32)
    for mode in ("sum", "mean"):
        want = np.asarray(JR.embedding_bag(jnp.asarray(table),
                                           jnp.asarray(idx),
                                           jnp.asarray(seg), B, mode=mode))
        got = TR.embedding_bag(torch.from_numpy(table),
                               torch.from_numpy(idx),
                               torch.from_numpy(seg), B, mode=mode)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
