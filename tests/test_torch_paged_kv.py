"""Port vs reference: the paged KV allocator (``paged/kv_cache.py``).

Identical ``append`` streams go to both packages — ragged joins, slots
that pause and come back with their chains, pools driven into the
sticky ``overflow`` — and then the allocator leaves (``link``,
``watermark``, ``tail``, ``length``, ``overflow``) must be bit-identical,
the heaps bit-identical (both are given the same k/v arrays), and the
page tables, tail addresses and ``gather_kv`` outputs equal.  The staged
per-layer write is checked with B == Hkv, where a numpy-vs-torch
indexing slip would transpose k/v without failing.  Everything is exact:
the tolerance is zero.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pointers as jp
from repro.paged import kv_cache as JP
from repro_torch.core import convert
from repro_torch.core import pointers as tp
from repro_torch.paged import kv_cache as TP

LEAVES = ("link", "watermark", "tail", "length", "overflow")


def _cfgs(z, spp, L=2, Hkv=2, D=8, max_seqs=8):
    kw = dict(n_layers=L, n_kv_heads=Hkv, d_head=D, max_seqs=max_seqs)
    return (JP.PagedKVConfig(layout=jp.PoolLayout(z=z, slices_per_pool=spp),
                             **kw),
            TP.PagedKVConfig(layout=tp.PoolLayout(z=z, slices_per_pool=spp),
                             **kw))


def _leaves(jstate):
    return {f: np.asarray(getattr(jstate, f)) for f in jstate._fields}


def _assert_same_state(jstate, tstate):
    want = _leaves(jstate)
    got = convert.kv_state_to_numpy(tstate)
    for f in LEAVES + ("k_heap", "v_heap"):
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def _run(jcfg, tcfg, schedule, seed):
    """Feed ``schedule`` (a list of seq-id lists, one per step) to both
    allocators with the same random k/v; return both states."""
    rng = np.random.default_rng(seed)
    jst, tst = JP.init_kv_state(jcfg), TP.init_kv_state(tcfg, "cpu")
    japp, tapp = JP.make_append_fn(jcfg), TP.make_append_fn(tcfg, "cpu")
    for ids in schedule:
        shape = (jcfg.n_layers, len(ids), jcfg.n_kv_heads, jcfg.d_head)
        k = rng.normal(size=shape).astype(np.float32)
        v = rng.normal(size=shape).astype(np.float32)
        jst = japp(jst, jnp.asarray(ids, jnp.int32), jnp.asarray(k),
                   jnp.asarray(v))
        tst = tapp(tst, torch.as_tensor(ids), torch.from_numpy(k),
                   torch.from_numpy(v))
    return jst, tst


def _ragged():
    joined, out = [], []
    for t in range(80):
        if t % 10 == 0 and len(joined) < 12:
            joined.append(len(joined))
        out.append(list(joined))
    return out


def _paused():
    """Slots 1 and 3 stop for a while and come back (a reused slot keeps
    its chain); slot 5 joins late; one step has a single sequence."""
    out = []
    for t in range(400):
        ids = [0, 2] + ([1, 3] if not 60 <= t < 200 else []) + (
            [5] if t >= 150 else [])
        out.append(sorted(ids) if t != 333 else [2])
    return out


def _overflowing():
    """Tiny pools: sequence 1 finds pool 1 empty at its 65th token, then
    new sequences find pool 0 empty (their tails stay NULL)."""
    return [[0, 1]] * 70 + [[0, 1, 2]] * 3 + [[3, 4, 0]] * 2 + [[1]] * 5


CASES = {
    "ragged": ((6, 8, 10), (64, 32, 16), _ragged, dict(L=1, Hkv=1, D=8,
                                                       max_seqs=16)),
    "paused": ((6, 8, 10), (16, 8, 4), _paused, dict(L=2, Hkv=2, D=16)),
    "overflow": ((6, 8, 10), (2, 1, 1), _overflowing, dict(L=2, Hkv=2, D=8,
                                                           max_seqs=6)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def streams(request):
    z, spp, sched, kw = CASES[request.param]
    jcfg, tcfg = _cfgs(z, spp, **kw)
    schedule = sched()
    jst, tst = _run(jcfg, tcfg, schedule, seed=len(schedule))
    return request.param, jcfg, tcfg, jst, tst


def test_allocator_leaves_and_heaps_bit_identical(streams):
    name, jcfg, tcfg, jst, tst = streams
    _assert_same_state(jst, tst)
    assert bool(tst.overflow) == (name == "overflow")
    assert TP.kv_slots_allocated(tcfg, tst) == \
        JP.kv_slots_allocated(jcfg, jst)


@pytest.mark.parametrize("max_pages", [1, 3, 8, 40])
def test_tables_tail_addrs_and_gather_equal(streams, max_pages):
    _, jcfg, tcfg, jst, tst = streams
    ids = np.arange(jcfg.max_seqs)
    want = np.asarray(JP.make_page_table_fn(jcfg, max_pages)(
        jst, jnp.asarray(ids, jnp.int32)))
    got = TP.make_page_table_fn(tcfg, max_pages, "cpu")(
        tst, torch.as_tensor(ids))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TP.make_tail_addr_fn(tcfg, "cpu")(tst, torch.as_tensor(ids)).numpy(),
        np.asarray(JP.make_tail_addr_fn(jcfg)(jst, jnp.asarray(
            ids, jnp.int32))).astype(np.int64))
    for layer in range(jcfg.n_layers):
        jk, jv = JP.gather_kv(jst, jnp.asarray(want), layer)
        tk, tv = TP.gather_kv(tst, got, layer)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("case", ["fresh", "overflow"])
def test_write_layer_kv_with_b_equal_hkv(case):
    """Staged per-layer writes after an append, B == Hkv == 3; in the
    overflow case one write lane holds a NULL tail's wrapped address,
    which the reference drops or wraps and the port must too."""
    spp = (64, 32, 16) if case == "fresh" else (2, 1, 1)
    jcfg, tcfg = _cfgs((6, 8, 10), spp, L=2, Hkv=3, D=4, max_seqs=4)
    sched = [[0, 1, 2]] * 5 if case == "fresh" else \
        [[0, 1]] * 3 + [[0, 1, 3]]
    jst, tst = _run(jcfg, tcfg, sched, seed=3)
    ids = sched[-1]
    rng = np.random.default_rng(4)
    jaddr = JP.make_tail_addr_fn(jcfg)(jst, jnp.asarray(ids, jnp.int32))
    taddr = TP.make_tail_addr_fn(tcfg, "cpu")(tst, torch.as_tensor(ids))
    if case == "overflow":
        assert bool(tst.overflow) and int(tst.length[3]) == 0
    for layer in range(jcfg.n_layers):
        k = rng.normal(size=(3, 3, 4)).astype(np.float32)
        v = rng.normal(size=(3, 3, 4)).astype(np.float32)
        jst = JP.write_layer_kv(jst, layer, jaddr, jnp.asarray(k),
                                jnp.asarray(v))
        TP.write_layer_kv(tst, layer, taddr, torch.from_numpy(k),
                          torch.from_numpy(v))
    _assert_same_state(jst, tst)
    if case == "fresh":    # the write landed, untransposed
        a = int(taddr[1])
        np.testing.assert_array_equal(tst.k_heap[1][:, a].numpy(), k[1])


def test_state_carries_across_both_ways():
    """A reference state loaded into the port and a port state loaded
    into the reference keep appending identically."""
    jcfg, tcfg = _cfgs((6, 8, 10), (16, 8, 4), L=1, Hkv=2, D=8)
    sched = [[0, 1, 2]] * 70
    jst, tst = _run(jcfg, tcfg, sched, seed=9)
    t2 = convert.kv_state_from_numpy(_leaves(jst), "cpu")
    j2 = JP.PagedKVState(**{f: jnp.asarray(a) for f, a in
                            convert.kv_state_to_numpy(tst).items()})
    rng = np.random.default_rng(10)
    japp, tapp = JP.make_append_fn(jcfg), TP.make_append_fn(tcfg, "cpu")
    for _ in range(200):
        k = rng.normal(size=(1, 2, 2, 8)).astype(np.float32)
        j2 = japp(j2, jnp.asarray([1, 2], jnp.int32), jnp.asarray(k),
                  jnp.asarray(k))
        t2 = tapp(t2, torch.as_tensor([1, 2]), torch.from_numpy(k),
                  torch.from_numpy(k))
    _assert_same_state(j2, t2)


def test_analytical_copies_agree():
    lens = np.asarray([0, 1, 63, 64, 65, 320, 321, 2048, 5000])
    for z in ((6, 8, 10), (6, 7, 8), (10, 11, 12)):
        np.testing.assert_array_equal(TP.kv_memory_slots(z, lens),
                                      JP.kv_memory_slots(z, lens))
        np.testing.assert_array_equal(TP.kv_pages_touched(z, lens),
                                      JP.kv_pages_touched(z, lens))
    assert TP.default_kv_layout() == tp.PoolLayout(
        z=(6, 8, 10), slices_per_pool=(512, 256, 128))
