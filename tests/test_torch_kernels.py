"""Port vs reference: every kernel's plain version, and the packing.

* Host packing (``pack_docids``, ``stack_packed``, ``repad_stacked``)
  must give byte-identical payloads and block tables.
* Each plain torch version in ``repro_torch.kernels.ref`` must equal
  the JAX package's oracle (``repro.kernels.ref``) on the same inputs,
  and — one small case each — the JAX Pallas kernel run in interpret
  mode.  Integer outputs, tolerance 0.
* On the CPU, ``kernels.ops`` routes to the plain version; the CUDA
  wrappers themselves refuse CPU tensors (no silent fallback).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bulk_append as j_ba
from repro.kernels import postings_intersect as j_pi
from repro.kernels import ref as jref
from repro.kernels import segment_intersect as jsi
from repro_torch.kernels import bulk_append as t_ba
from repro_torch.kernels import ops
from repro_torch.kernels import postings_intersect as t_pi
from repro_torch.kernels import segment_intersect as tsi

INVALID = 0xFFFFFFFF
ID_CASES = [0, 1, 5, 127, 128, 129, 700, 3000]


def _ids(rng, n, span):
    return np.unique(rng.integers(0, span, n)).astype(np.uint32)


def _lists(seed):
    """Docid lists with every gap width: dense (bw 1), medium (bw 2),
    sparse (bw 4), plus empty and block-edge lengths."""
    rng = np.random.default_rng(seed)
    spans = [300, 70000, 1 << 22, 1 << 31]
    return [_ids(rng, n, spans[i % len(spans)])
            for i, n in enumerate(ID_CASES)]


def _j2n(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_docids_byte_identical(seed):
    for ids in _lists(seed):
        j, t = jsi.pack_docids(ids), tsi.pack_docids(ids)
        assert j.n == t.n
        for f in ("firsts", "bws", "woffs", "payload"):
            a, b = np.asarray(getattr(j, f)), getattr(t, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        np.testing.assert_array_equal(tsi.decode_packed(t, "cpu").numpy(),
                                      _j2n(jsi.decode_packed(j)))


def _stacks(seed, rows=6):
    lists = _lists(seed)[:rows]
    jp_ = [jsi.pack_docids(x) for x in lists]
    tp_ = [tsi.pack_docids(x) for x in lists]
    return jsi.stack_packed(jp_), tsi.stack_packed(tp_), lists


def test_stack_and_repad_byte_identical():
    js, ts, _ = _stacks(0)
    for f in jsi.StackedLists._fields:
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    nb, pw = js.n_blocks * 4, js.n_words * 2
    jr, tr = jsi.repad_stacked(js, nb, pw), tsi.repad_stacked(ts, nb, pw)
    for f in jsi.StackedLists._fields:
        np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f))
    got = tsi.decode_stacked(tr.to("cpu")).numpy()
    np.testing.assert_array_equal(got, _j2n(jsi.decode_stacked(
        jax_stack(jr))))


def jax_stack(s):
    return jsi.StackedLists(*[jnp.asarray(getattr(s, f))
                              for f in jsi.StackedLists._fields])


def test_decode_stacked_handles_every_width():
    js, ts, lists = _stacks(1, rows=8)
    got = tsi.decode_stacked(ts.to("cpu")).numpy()
    np.testing.assert_array_equal(got, _j2n(jsi.decode_stacked(
        jax_stack(js))))
    for r, ids in enumerate(lists):
        np.testing.assert_array_equal(got[r, : ids.size], ids)
        assert (got[r, ids.size:] == INVALID).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_intersect_mask_plain_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    na = nb = 512
    a = np.full(na, INVALID, np.uint32)
    b = np.full(nb, INVALID, np.uint32)
    x, y = _ids(rng, 300, 1000), _ids(rng, 400, 1000)
    a[: x.size], b[: y.size] = x, y
    want = np.asarray(jref.intersect_mask_ref(jnp.asarray(a),
                                              jnp.asarray(b)))
    got = ops.intersect_mask(torch.as_tensor(a.astype(np.int64)),
                             torch.as_tensor(b.astype(np.int64)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_intersect_mask_interpret_kernel():
    """The Pallas kernel in interpret mode agrees with the port."""
    rng = np.random.default_rng(9)
    a = np.full(256, INVALID, np.uint32)
    b = np.full(256, INVALID, np.uint32)
    x, y = _ids(rng, 150, 400), _ids(rng, 200, 400)
    a[: x.size], b[: y.size] = x, y
    want = np.asarray(j_pi.intersect_mask(jnp.asarray(a), jnp.asarray(b),
                                          ta=128, tb=128, interpret=True))
    got = ops.intersect_mask(torch.as_tensor(a.astype(np.int64)),
                             torch.as_tensor(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


def _bulk_operands(seed, H=600, V=40, n=300):
    """Unique live addresses + distinct out-of-range skip lanes, like
    the bulk allocator emits."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(H)
    live = rng.random(n) < 0.6
    post_addr = np.where(live, perm[:n], H + np.arange(n))
    ptr_live = rng.random(n) < 0.2
    ptr_addr = np.where(ptr_live, perm[n: 2 * n], H + np.arange(n))
    tperm = rng.permutation(V)
    term_live = np.arange(n) < V // 2
    term_idx = np.where(term_live, np.resize(tperm, n), V + np.arange(n))
    vals = [rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
            for _ in range(3)]
    freq = rng.integers(0, 1000, n).astype(np.int32)
    heap = rng.integers(0, 1 << 32, H, dtype=np.uint64).astype(np.uint32)
    tail = rng.integers(0, 1 << 32, V, dtype=np.uint64).astype(np.uint32)
    fr = rng.integers(0, 100, V).astype(np.int32)
    return (heap, tail, fr, post_addr.astype(np.int32), vals[0],
            ptr_addr.astype(np.int32), vals[1], term_idx.astype(np.int32),
            vals[2], freq)


def _bulk_torch(ops_np):
    dts = [np.int64] * 2 + [np.int32] + [np.int64] * 6 + [np.int32]
    return [torch.as_tensor(x.astype(d)) for x, d in zip(ops_np, dts)]


@pytest.mark.parametrize("seed", [0, 1])
def test_bulk_append_plain_matches_oracle(seed):
    o = _bulk_operands(seed)
    want = jref.bulk_append_ref(*[jnp.asarray(x) for x in o])
    got = ops.bulk_append(*_bulk_torch(o))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), _j2n(w)
                                      if w.dtype == jnp.uint32
                                      else np.asarray(w))


def test_bulk_append_interpret_kernel():
    o = _bulk_operands(3, H=300, V=20, n=64)
    want = j_ba.bulk_append(*[jnp.asarray(x) for x in o], interpret=True)
    got = ops.bulk_append(*_bulk_torch(o))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            g.numpy().dtype))


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_intersect_batched_plain_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    lists = _lists(seed)
    # b rows share a third of a's docids, plus noise; one empty b row
    b_lists = [np.unique(np.concatenate(
        [x[::3], _ids(rng, 40, 1 << 22)])).astype(np.uint32)
        for x in lists]
    b_lists[2] = np.zeros(0, np.uint32)
    ja = jsi.stack_packed([jsi.pack_docids(x) for x in lists])
    jb = jsi.stack_packed([jsi.pack_docids(x) for x in b_lists])
    ta = tsi.stack_packed([tsi.pack_docids(x) for x in lists])
    tb = tsi.stack_packed([tsi.pack_docids(x) for x in b_lists])
    want = np.asarray(jref.segment_intersect_mask_batched_ref(
        jax_stack(ja), jax_stack(jb)))
    got = ops.segment_intersect_mask_batched(ta.to("cpu"), tb.to("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


def test_segment_intersect_batched_interpret_kernel():
    rng = np.random.default_rng(4)
    a = [_ids(rng, n, 5000) for n in (0, 130, 300)]
    b = [_ids(rng, n, 5000) for n in (40, 0, 500)]
    ja = jsi.stack_packed([jsi.pack_docids(x) for x in a])
    jb = jsi.stack_packed([jsi.pack_docids(x) for x in b])
    want = np.asarray(jsi.segment_intersect_mask_batched(
        jax_stack(ja), jax_stack(jb), interpret=True))
    ta = tsi.stack_packed([tsi.pack_docids(x) for x in a]).to("cpu")
    tb = tsi.stack_packed([tsi.pack_docids(x) for x in b]).to("cpu")
    got = ops.segment_intersect_mask_batched(ta, tb)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("na,nb", [(0, 5), (5, 0), (300, 3000),
                                   (129, 128), (3000, 700)])
def test_segment_intersect_single_plain_matches_oracle(na, nb):
    rng = np.random.default_rng(na + nb)
    x, y = _ids(rng, na, 1 << 20), _ids(rng, nb, 1 << 20)
    y = np.union1d(y, x[::2]).astype(np.uint32) if nb else y
    want = np.asarray(jref.segment_intersect_mask_ref(
        jsi.pack_docids(x), jsi.pack_docids(y)))
    got = ops.segment_intersect_mask(tsi.pack_docids(x).to("cpu"),
                                     tsi.pack_docids(y).to("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_intersect_single_interpret_kernel():
    rng = np.random.default_rng(8)
    x, y = _ids(rng, 200, 3000), _ids(rng, 300, 3000)
    want = np.asarray(jsi.segment_intersect_mask(
        jsi.pack_docids(x), jsi.pack_docids(y), interpret=True))
    got = ops.segment_intersect_mask(tsi.pack_docids(x).to("cpu"),
                                     tsi.pack_docids(y).to("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_pick_tile_matches():
    for n in (1, 3, 96, 256, 1000, 4096):
        assert t_pi.pick_tile(n) == j_pi.pick_tile(n)


def test_cpu_routes_to_plain_versions_and_counts_nothing():
    ops.reset_launch_counts()
    a = torch.arange(256, dtype=torch.int64)
    ops.intersect_mask(a, a)
    ops.bulk_append(*_bulk_torch(_bulk_operands(0)))
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_cuda_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never runs the plain version: handed CPU tensors
    it raises instead of computing."""
    a = torch.arange(256, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        t_pi.intersect_mask(a, a)
    with pytest.raises(ValueError, match="CUDA"):
        t_ba.bulk_append(*_bulk_torch(_bulk_operands(0)))
    p = tsi.pack_docids(np.arange(300, dtype=np.uint32)).to("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tsi.segment_intersect_mask(p, p)
    s = tsi.stack_packed([tsi.pack_docids(np.arange(5, dtype=np.uint32))])
    s = s.to("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tsi.segment_intersect_mask_batched(s, s)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
