"""The embedding-bag kernel's launch plan and summation order, on the CPU.

``kernels.embedding_bag.launch_plan`` picks the CUDA kernel's row-load
width, lanes per row, rows in flight, chunk size and grid from shapes,
the table's address and the SM count; here it is held at every recsys
width and dtype, at aligned and misaligned base addresses: every bag in
exactly one chunk, the loads aligned and covering the row.

``_kernel_mirror`` (test-only) walks the kernel's decomposition with that
plan in numpy fp32 (chunks of bags; single-row chunks row by row, the
others in tiles of groups x rows per lane with the in-register fold and
the carry from group to group and tile to tile; empty bags) and must
equal ``in_order_bags`` (the kernel's order: each bag from its first
row, one row at a time) bit for bit.  The path's bag
patterns also go through the port's CPU route against the JAX oracle
``repro.kernels.ref.embedding_bag_ref`` and, once, the Pallas kernel in
interpret mode.

Tolerance: rtol = atol = 1e-5 in fp32 against the JAX package (sums of
up to 100 rows taken in another order; bags of one row are exact); bit
equality between the mirror and the in-order sum.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import embedding_bag as teb
from repro_torch.kernels import ops as tops
from repro_torch.launch import time_embedding_bag as tbag

TOL = dict(rtol=1e-5, atol=1e-5)
H100_SMS = 132
WIDTHS = (1, 10, 16, 18, 128)
ESIZE = {torch.float32: 4, torch.bfloat16: 2}


def _check_plan(p, D, esize, base, n, B, sms):
    assert p.vec_bytes in (16, 8, 4, 2) and p.vec_bytes >= esize
    assert (D * esize) % p.vec_bytes == 0 and base % p.vec_bytes == 0
    assert p.vec == p.vec_bytes // esize and D % p.vec == 0
    assert p.vec <= teb.MAX_VEC
    wider = [v for v in (16, 8, 4) if p.vec_bytes < v <= teb.MAX_VEC * esize]
    assert not any((D * esize) % v == 0 and base % v == 0 for v in wider)
    # the lanes of a row cover it (in passes of 32 lanes past 32 loads)
    assert p.lanes_per_row == min(32, -(-D // p.vec))
    assert p.groups == 32 // p.lanes_per_row
    assert p.groups * p.lanes_per_row <= 32
    assert p.rows_per_lane == teb.ROWS_PER_LANE
    # every bag in exactly one chunk, no chunk empty
    assert 1 <= p.bags_per_chunk <= teb.MAX_BAGS
    assert p.chunks == -(-B // p.bags_per_chunk)
    assert (p.chunks - 1) * p.bags_per_chunk < B <= \
        p.chunks * p.bags_per_chunk
    assert 1 <= p.grid <= teb.MAX_GRID
    assert p.grid * teb.WARPS >= min(p.chunks, teb.MAX_GRID * teb.WARPS)
    # a chunk is about a tile of rows: never more than two
    tile = p.groups * p.rows_per_lane
    assert p.bags_per_chunk * max(n / max(B, 1), 1) <= 2 * tile or \
        p.bags_per_chunk == 1


@pytest.mark.parametrize("D", WIDTHS + (3, 32, 64, 200))
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", ["aligned", "odd row", "odd element"])
def test_plan_at_every_width_dtype_and_alignment(D, dt, shift):
    esize = ESIZE[dt]
    base = 1 << 21
    base += {"aligned": 0, "odd row": D * esize, "odd element": esize}[shift]
    for n, B in [(B * L, B) for B, L, _, _, _ in tbag.PATH_SHAPES] + \
            [(0, 7), (5, 1), (10_000, 3), (1 << 20, 1 << 20)]:
        for sms in (1, H100_SMS):
            _check_plan(teb.launch_plan(D, esize, base, n, B, sms), D, esize,
                        base, n, B, sms)


# the plan at the ten path calls on 132 SMs: (bytes a load, lanes a row,
# bags a chunk)
PATH_PLANS = ((16, 4, 32), (16, 4, 32), (16, 4, 1), (16, 4, 32), (8, 5, 24),
              (4, 1, 1), (8, 9, 12), (8, 9, 12), (8, 9, 1), (8, 32, 8))


@pytest.mark.parametrize("i", range(len(tbag.PATH_SHAPES)))
def test_plan_at_the_path_calls(i):
    """At the ten calls of the recsys path (an aligned table), the loads
    are as wide as the row allows up to 4 elements: 16 bytes at D = 16
    fp32, 8 at D = 10 and 18 fp32 and at D = 128 bf16, 4 at D = 1; a
    chunk is a tile of single rows (DLRM's 13,312 take two tiles of 4
    a warp, rather than a second wave), and one long bag a warp when there are few."""
    B, L, D, dt, _ = tbag.PATH_SHAPES[i]
    p = teb.launch_plan(D, ESIZE[dt], 1 << 21, B * L, B, H100_SMS)
    assert (p.vec_bytes, p.lanes_per_row, p.bags_per_chunk) == PATH_PLANS[i]
    _check_plan(p, D, ESIZE[dt], 1 << 21, B * L, B, H100_SMS)
    if L == 1 and B <= 13_312:
        assert p.grid <= teb.CTAS_PER_SM * H100_SMS


def test_plan_refuses_nothing_the_table_can_take():
    """A fp32 table always takes 4-byte loads and a bf16 table 2-byte
    loads, whatever its address (PyTorch aligns a tensor to its
    element)."""
    for D in range(1, 40):
        for esize in (2, 4):
            for off in range(0, 16, esize):
                p = teb.launch_plan(D, esize, 4096 + off, 100, 10, 4)
                assert p.vec_bytes >= esize
                assert (4096 + off) % p.vec_bytes == 0


def _kernel_mirror(table, idx, off, mode, plan):
    """The CUDA kernel's walk over one call, in numpy fp32: returns the
    output, NaN where no bag was written."""
    tab = table.float().numpy()
    idx = idx.numpy().astype(np.int64)
    off = off.numpy().astype(np.int64)
    R, D = tab.shape
    n, B = idx.size, off.size - 1
    G, U, K = plan.groups, plan.rows_per_lane, plan.bags_per_chunk
    out = np.full((B, D), np.nan, np.float32)
    for c in range(plan.chunks):
        b0 = c * K
        kc = min(K, B - b0)
        lo = np.clip(off[b0:b0 + kc], 0, n)
        hi = np.maximum(lo, np.minimum(off[b0 + 1:b0 + kc + 1], n))
        st = np.concatenate([[0], np.cumsum(hi - lo)])
        T = int(st[-1])
        if (hi - lo == 1).all() and (lo - st[:-1] == lo[0]).all():
            # one row a bag at consecutive positions: slot u of group g
            # takes row u * G + g and stores it as it is (a mean / 1)
            for t0 in range(0, T, G * U):
                for g in range(G):
                    for u in range(U):
                        t = t0 + u * G + g
                        if t < T:
                            x = tab[min(max(idx[lo[0] + t], 0), R - 1)]
                            out[b0 + t] = x / np.float32(1) \
                                if mode == "mean" else x
            continue
        acc = np.zeros((G, D), np.float32)
        carry = np.zeros(D, np.float32)
        for t0 in range(0, T, G * U):
            slots = []
            for g in range(G):
                row = []
                for u in range(U):
                    t = t0 + g * U + u
                    if t >= T:
                        row.append(None)
                        continue
                    k = int(np.searchsorted(st[:kc], t, "right") - 1)
                    x = tab[min(max(idx[lo[k] + t - st[k]], 0), R - 1)]
                    row.append((t, k, x))
                slots.append(row)

            def fold(g):
                for s in slots[g]:
                    if s is None:
                        continue
                    t, k, x = s
                    acc[g] = x if t == st[k] else acc[g] + x
                    if t + 1 == st[k + 1]:
                        cnt = np.float32(st[k + 1] - st[k])
                        out[b0 + k] = acc[g] / cnt if mode == "mean" \
                            else acc[g]
            need = any(s[0] is not None and s[0][0] != st[s[0][1]]
                       for s in slots)
            if not need:
                for g in range(G):
                    fold(g)
            else:
                for g in range(G):
                    acc[g] = carry if g == 0 else acc[g - 1]
                    fold(g)
            carry = acc[G - 1].copy()
        out[b0:b0 + kc][hi - lo == 0] = 0.0
    return out


def _csr(lens, start=0):
    off = np.zeros(len(lens) + 1, np.int64)
    off[1:] = np.cumsum(lens)
    return torch.from_numpy((off + start).astype(np.int32))


# (name, rows per bag or lengths, D, dtype, mode): the path's patterns
# (bag counts cut), then the edge cases of the chunked walk
PATTERNS = [
    ("user mean-bag", [26], 16, torch.float32, "mean"),
    ("linear sum-bags", [39] * 12, 1, torch.float32, "sum"),
    ("history mean-bags", [100] * 6, 18, torch.float32, "mean"),
    ("single rows D=10", [1] * 300, 10, torch.float32, "sum"),
    ("single rows D=16", [1] * 700, 16, torch.float32, "sum"),
    ("single rows D=18", [1] * 300, 18, torch.float32, "sum"),
    ("single rows D=128 bf16", [1] * 90, 128, torch.bfloat16, "sum"),
]
EDGES = [
    ("long bags among short", [0, 1, 300, 3, 0, 1, 77, 2, 513, 64, 5], 16,
     torch.float32, "sum"),
    ("empty bags", [0, 0, 4, 0, 1, 0, 0], 18, torch.float32, "mean"),
    ("wide rows in passes", [3, 1, 0, 9], 200, torch.float32, "sum"),
    ("bf16 odd width", [2, 1, 5, 1, 1], 9, torch.bfloat16, "mean"),
]


def _pattern(lens, D, dt, seed, R=500, spill=5):
    """A table of ``R`` rows and CSR bags of ``lens``; ids up to
    ``spill`` past either end of the table (clipped)."""
    rng = np.random.default_rng(seed)
    off = _csr(lens)
    idx = torch.from_numpy(rng.integers(-spill, R + spill, int(off[-1]))
                           .astype(np.int32))
    table = torch.from_numpy(rng.normal(size=(R, D)).astype(np.float32))
    return table.to(dt), idx, off


@pytest.mark.parametrize("sms", [1, H100_SMS])
@pytest.mark.parametrize("case", PATTERNS + EDGES, ids=lambda c: c[0])
def test_kernel_mirror_sums_in_bag_order(case, sms):
    """The kernel's chunked walk, at the plan it gets, equals the
    in-order sum bit for bit, writes every bag, and a single-row bag is
    the table's row."""
    name, lens, D, dt, mode = case
    table, idx, off = _pattern(lens, D, dt, seed=len(name))
    plan = teb.launch_plan(D, ESIZE[dt], 1 << 21, idx.numel(), len(lens),
                           sms)
    got = _kernel_mirror(table, idx, off, mode, plan)
    want = tbag.in_order_bags(table, idx, off, mode).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got, want)
    one = np.diff(off.numpy()) == 1
    rows = table.float().numpy()[np.clip(idx.numpy()[off.numpy()[:-1][one]],
                                         0, table.shape[0] - 1)]
    np.testing.assert_array_equal(got[one], rows)


@pytest.mark.parametrize("chunk", [1, 2, 3, 7, 128])
@pytest.mark.parametrize("lpr,U", [(1, 8), (4, 4), (9, 8), (32, 4)])
def test_kernel_mirror_at_forced_chunks_and_tiles(chunk, lpr, U):
    """Chunks of 1 to 128 bags and tiles of 3 to 256 rows cut bags of 0
    to 600 rows at every place: the walk still sums in bag order."""
    rng = np.random.default_rng(chunk * 100 + lpr)
    lens = rng.integers(0, 40, 60)
    lens[[3, 17, 40]] = (600, 257, 96)
    lens[rng.integers(0, 60, 10)] = 1
    table, idx, off = _pattern(lens, 18, torch.float32, seed=chunk)
    B = len(lens)
    plan = teb.BagPlan(vec_bytes=8, vec=2, lanes_per_row=lpr,
                       groups=32 // lpr, rows_per_lane=U,
                       bags_per_chunk=chunk, chunks=-(-B // chunk), grid=1)
    for mode in ("sum", "mean"):
        got = _kernel_mirror(table, idx, off, mode, plan)
        np.testing.assert_array_equal(
            got, tbag.in_order_bags(table, idx, off, mode).numpy())


def test_kernel_mirror_on_a_malformed_csr():
    """Decreasing, negative and past-the-end offsets clamp per bag (lo =
    clip(offsets[b]), hi = max(lo, min(offsets[b + 1], N))), as the
    kernel does; offsets[0] > 0 leaves the head of the indices unused."""
    rng = np.random.default_rng(9)
    n, R, D = 400, 300, 10
    table = torch.from_numpy(rng.normal(size=(R, D)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, R, n).astype(np.int32))
    bad = rng.integers(-50, n + 50, 61).astype(np.int32)
    bad[::5] = np.sort(bad[::5])[::-1]
    for off in (torch.from_numpy(bad), _csr(rng.integers(0, 9, 30), 37)):
        lo, hi = tbag.bag_bounds(off, n)
        assert bool((lo >= 0).all() and (hi <= n).all() and (hi >= lo).all())
        for sms in (1, H100_SMS):
            plan = teb.launch_plan(D, 4, 1 << 21, n, off.numel() - 1, sms)
            for mode in ("sum", "mean"):
                np.testing.assert_array_equal(
                    _kernel_mirror(table, idx, off, mode, plan),
                    tbag.in_order_bags(table, idx, off, mode).numpy())


def _jax(table, idx, off, mode, pallas=False):
    t = table.float().numpy() if table.dtype == torch.float32 else \
        table.float().numpy().astype(ml_dtypes.bfloat16)
    args = (jnp.asarray(t), jnp.asarray(idx.numpy()),
            jnp.asarray(off.numpy()))
    if pallas:
        return np.asarray(jops.embedding_bag(*args, mode=mode,
                                             interpret=True))
    return np.asarray(jref.embedding_bag_ref(*args, mode=mode)
                      .astype(jnp.float32))


@pytest.mark.parametrize("case", PATTERNS, ids=lambda c: c[0])
def test_path_patterns_on_the_cpu_route_against_the_jax_oracle(case):
    """The port's CPU route and the in-order sum against the JAX oracle
    (an fp32 table: the three agree within TOL; single-row bags exactly,
    a bf16 table included, whose rows widen exactly)."""
    name, lens, D, dt, mode = case
    table, idx, off = _pattern(lens, D, dt, seed=len(name) + 1)
    got = tops.embedding_bag(table, idx, off, mode).numpy()
    order = tbag.in_order_bags(table, idx, off, mode).numpy()
    want = _jax(table, idx, off, mode)
    assert got.shape == want.shape == (len(lens), D)
    if lens[0] == 1:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(order, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(order, want, **TOL)


def test_path_patterns_against_the_pallas_kernel():
    """Once, the three multi-row patterns and a single-row one through
    the Pallas kernel in interpret mode (its fp32 sum in bag order)."""
    for name, lens, D, dt, mode in PATTERNS[:4]:
        table, idx, off = _pattern(lens[:6], D, dt, seed=3, spill=0)
        pallas = _jax(table, idx, off, mode, pallas=True)
        np.testing.assert_allclose(
            tbag.in_order_bags(table, idx, off, mode).numpy(), pallas, **TOL)
        np.testing.assert_allclose(
            tops.embedding_bag(table, idx, off, mode).numpy(), pallas, **TOL)
