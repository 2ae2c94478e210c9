"""The embedding-bag backward kernel's summation order, on the CPU.

``launch/time_embedding_bag_backward.in_order_backward`` states the
order the CUDA kernel (``csrc/embedding_bag_backward.cu``) adds each
row's contributions in: pieces of ``BWD_CHUNK``-entry chunks of the
sorted positions, each summed in position order from 0.0, left-folded in
chunk order.  Here it is held

* bit-equal to the plain version (``ref.embedding_bag_backward_ref``) on
  rows of one contribution and on runs inside one chunk, and within 1e-5
  of the summed magnitudes elsewhere;
* bit-equal, window by window, to the whole table's result (S = 2 and 4
  windows, the second window's phase 0, 1 and 31);
* bit-equal to :func:`kernel_mirror`, a numpy walk of the kernel's own
  decomposition (the touched-row bits and zero stores, the chunk jobs'
  runs, heads and tails, the fold of each run across chunks), which also
  checks that every row is written exactly once;
* within 1e-5 of the JAX package's gradient of its bag.

The cases cover fp32 and bf16 tables, sum and mean, empty bags, clipped
ids, positions outside every bag and a run that spans more than 64
chunks.  The kernel itself runs only on the card (``chip_smoke.py``
phases 6r and 10, ``tests/test_torch_guards.py``'s card tests).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recsys as JR
from repro_torch.kernels import embedding_bag as teb
from repro_torch.kernels import ref as tref
from repro_torch.launch import time_embedding_bag_backward as tbwd

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
TOL = 1e-5       # rows of runs across chunks: x their summed magnitudes


def _case(seed: int, R: int = 700, D: int = 16, B: int = 300,
          hot: int = 2500):
    """A CSR of ``B`` bags of 0-8 rows (a fifth empty) after 5 unused
    positions, 7 more after the last bag, ids clipped at both ends and a
    Zipf-heavy id stream; then ``hot`` single-row bags of one row (as
    DCN-v2's small fields give: a run over ``hot / 32`` chunks); fp32
    grad_out [B + hot, D]."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 9, B)
    lens[rng.random(B) < 0.2] = 0
    lens = np.concatenate([lens[:B // 2], np.ones(hot, np.int64),
                           lens[B // 2:]])
    off = np.concatenate([[5], 5 + np.cumsum(lens)]).astype(np.int32)
    n = int(off[-1]) + 7
    idx = (rng.zipf(1.3, n) % (R + 40) - 20).astype(np.int32)
    a = int(off[B // 2])
    idx[a:a + hot] = R // 3
    idx[:3] = (-9, R + 5, R - 1)
    g = rng.normal(size=(B + hot, D)).astype(np.float32)
    return torch.as_tensor(g), torch.as_tensor(idx), torch.as_tensor(off)


def _sorted_rows(idx, off, R):
    """Each in-bag position's clipped row, and each row's count and
    number of chunks its run covers in the whole table's sort."""
    pos = np.arange(idx.shape[0])
    inside = (pos >= off[0]) & (pos < off[-1])
    rows = np.sort(np.clip(idx, 0, R - 1)[inside], kind="stable")
    cnt = np.bincount(rows, minlength=R)
    k = np.arange(rows.size)
    first = np.full(R, -1)
    last = np.full(R, -1)
    first[rows[::-1]] = k[::-1]
    last[rows] = k
    chunks = np.where(cnt > 0, last // teb.BWD_CHUNK
                      - first // teb.BWD_CHUNK + 1, 0)
    return cnt, chunks


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("seed", [0, 1])
def test_in_order_matches_the_plain_version(dtype, mode, seed):
    """Bit-equal to the plain version where the order is the same (one
    contribution, or one chunk's in-order sum), within ``TOL`` of the
    summed magnitudes where chunks associate the sum, zero where nothing
    lands; a bf16 table gets the fp32 sum cast once."""
    R = 700
    g, idx, off = _case(seed, R)
    dt = DTYPES[dtype]
    got = tbwd.in_order_backward(g, idx, off, mode, R, dt)
    want = tref.embedding_bag_backward_ref(g, idx, off, mode, R, dt)
    assert got.shape == (R, 16) and got.dtype == dt
    cnt, chunks = _sorted_rows(idx.numpy(), off.numpy(), R)
    same = torch.as_tensor(chunks == 1)
    assert int((chunks > 64).sum()) == 1 and int((cnt == 1).sum()) > 50
    assert torch.equal(got[same], want[same])
    assert torch.equal(got[torch.as_tensor(cnt == 0)],
                       torch.zeros_like(got[torch.as_tensor(cnt == 0)]))
    f32 = tbwd.in_order_backward(g, idx, off, mode, R, torch.float32)
    assert torch.equal(got, f32.to(dt))
    mag = tref.embedding_bag_backward_ref(g.abs(), idx, off, mode, R,
                                          torch.float32)
    ref32 = tref.embedding_bag_backward_ref(g, idx, off, mode, R,
                                            torch.float32)
    assert bool(((f32 - ref32).abs() <= TOL * mag).all())


def _with_phase(g, idx, off, R: int, S: int, phase: int):
    """The case with positions of row 0 added to its last bag so that
    the second of ``S`` windows starts at sorted entry ``phase`` mod
    ``BWD_CHUNK`` of the whole table's sort."""
    lo1 = R // S
    pos = np.arange(idx.shape[0])
    o = off.numpy()
    inside = (pos >= o[0]) & (pos < o[-1])
    below = int((inside & (np.clip(idx.numpy(), 0, R - 1) < lo1)).sum())
    extra = (phase - below) % teb.BWD_CHUNK
    i = idx.numpy()
    end = int(o[-1])
    i = np.concatenate([i[:end], np.zeros(extra, np.int32), i[end:]])
    o = o.copy()
    o[-1] += extra
    return g, torch.as_tensor(i), torch.as_tensor(o)


def _windows(R: int, S: int):
    return [(k * R // S, (k + 1) * R // S) for k in range(S)]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("phase", [0, 1, 31])
def test_in_order_windows_concatenate_to_the_whole(dtype, mode, S, phase):
    """Each window of a split of the table by rows, in its own call,
    keeps the whole sort's chunks (its plan's phase): the windows'
    blocks concatenate to the whole table's result bit for bit, and
    the plan's phase of the second window is the one built in."""
    R = 700
    g, idx, off = _with_phase(*_case(7 + phase, R), R, S, phase)
    dt = DTYPES[dtype]
    whole = tbwd.in_order_backward(g, idx, off, mode, R, dt)
    blocks = [tbwd.in_order_backward(g, idx, off, mode, R, dt, row_lo=lo,
                                     row_hi=hi) for lo, hi in _windows(R, S)]
    assert torch.equal(torch.cat(blocks), whole)
    lo, hi = _windows(R, S)[1]
    assert int(teb.sort_positions(idx, off, R, lo, hi)[2][0]) == phase


def kernel_mirror(g, idx, off, mode: str, R: int, dtype, row_lo: int = 0,
                  row_hi=None):
    """The CUDA kernel's decomposition walked in numpy, from the plain
    version of its keys and sort (``sort_positions``) and the wrapper's
    plan (``backward_plan``): kernels 0 and 1's bags and touched-row
    bits; kernel 2's chunk jobs (per chunk, each run inside it summed and
    written, the first run's head if it began in an earlier chunk, the
    last run's tail if it began there and goes on, that run listed with
    its end) and zero stores (the rows whose bit is clear); kernel 3's
    fold of each listed run: its first chunk's tail, then the following
    chunks' heads.  Asserts that every row is written once; returns the
    block in ``dtype``."""
    C = teb.BWD_CHUNK
    hi_w = R if row_hi is None else row_hi
    key, perm, phase = teb.sort_positions(idx, off, R, row_lo, hi_w)
    key, perm = key.numpy().astype(np.int64), perm.numpy().astype(np.int64)
    ph = 0 if phase is None else int(phase[0])
    Rw, N, D = hi_w - row_lo, key.shape[0], g.shape[1]
    o = off.numpy().astype(np.int64)
    B = o.shape[0] - 1
    gn = g.numpy()
    plan = teb.backward_plan(D, 0, N, Rw, shifted=phase is not None)
    touched = np.zeros(plan.words * 32, bool)
    for k in range(N):
        if key[k] < Rw and (k == 0 or key[k - 1] != key[k]):
            touched[key[k]] = True

    def x(k):          # sorted entry k's contribution
        b = min(int(np.searchsorted(o[1:], perm[k], side="right")), B - 1)
        v = gn[b].copy()
        if mode == "mean":
            v = v / np.float32(max(o[b + 1] - o[b], 1))
        return v

    out = np.zeros((Rw, D), np.float32)
    writes = (~touched[:Rw]).astype(np.int64)
    head = np.zeros((plan.n_chunks, D), np.float32)
    tail = np.zeros_like(head)
    listed = []
    for c in range(plan.n_chunks):
        s, e = max(c * C - ph, 0), min((c + 1) * C - ph, N)
        ks = key[s:e]
        nin = int((ks < Rw).sum())
        if nin == 0:
            continue
        cont_prev = s > 0 and key[s - 1] == ks[0]
        cont_next = nin == e - s and e < N and key[e] == ks[nin - 1]
        ja = 0
        while ja < nin:
            jb = ja + 1
            while jb < nin and ks[jb] == ks[ja]:
                jb += 1
            acc = np.zeros(D, np.float32)
            for k in range(s + ja, s + jb):
                acc = acc + x(k)
            if ja == 0 and cont_prev:
                head[c] = acc
            elif jb == nin and cont_next:
                tail[c] = acc
                b = int(np.searchsorted(key, ks[ja], side="right"))
                listed.append((ks[ja], s + ja, b))
            else:
                out[ks[ja]] = acc
                writes[ks[ja]] += 1
            ja = jb
    assert len(listed) < max(plan.n_chunks, 1)
    for row, a, b in listed:
        c0, c1 = (a + ph) // C, (b - 1 + ph) // C
        acc = tail[c0].copy()
        for c in range(c0 + 1, c1 + 1):
            acc = acc + head[c]
        out[row] = acc
        writes[row] += 1
    assert (writes == 1).all()
    return torch.as_tensor(out).to(dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("D", [4, 10, 16])
def test_kernel_decomposition_is_the_order(dtype, mode, D):
    """The kernel's zero stores, chunk jobs and folds (:func:`kernel_mirror`)
    give ``in_order_backward``'s bits, over the whole table and over each
    of 3 windows (every window shifted by its phase)."""
    R = 900
    g, idx, off = _case(30 + D, R, D=D, B=200, hot=1500)
    dt = DTYPES[dtype]
    want = tbwd.in_order_backward(g, idx, off, mode, R, dt)
    assert torch.equal(kernel_mirror(g, idx, off, mode, R, dt), want)
    for lo, hi in _windows(R, 3):
        assert torch.equal(
            kernel_mirror(g, idx, off, mode, R, dt, lo, hi), want[lo:hi])


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_kernel_decomposition_edges(mode):
    """No bag at all, bags that are all empty, every position outside
    the window, a table of one row, and runs that start and end exactly
    on chunk boundaries."""
    g = torch.randn(3, 8, generator=torch.Generator().manual_seed(3))
    cases = [
        (torch.zeros((0, 8)), torch.arange(40, dtype=torch.int32),
         torch.zeros(1, dtype=torch.int32), 50, (0, None)),
        (g, torch.arange(40, dtype=torch.int32),
         torch.tensor([4, 4, 4, 4], dtype=torch.int32), 50, (0, None)),
        (g, torch.full((64,), 45, dtype=torch.int32),
         torch.tensor([0, 20, 40, 64], dtype=torch.int32), 50, (0, 20)),
        (g, torch.arange(64, dtype=torch.int32),
         torch.tensor([0, 20, 40, 64], dtype=torch.int32), 1, (0, None)),
        (g, torch.repeat_interleave(torch.arange(3, dtype=torch.int32), 32),
         torch.tensor([0, 32, 64, 96], dtype=torch.int32), 50, (0, None)),
    ]
    for gg, i, o, R, (lo, hi) in cases:
        want = tbwd.in_order_backward(gg, i, o, mode, R, torch.float32,
                                      row_lo=lo, row_hi=hi)
        assert torch.equal(kernel_mirror(gg, i, o, mode, R, torch.float32,
                                         lo, hi), want)
        full = tref.embedding_bag_backward_ref(gg, i, o, mode, R,
                                               torch.float32, row_lo=lo,
                                               row_hi=hi)
        np.testing.assert_allclose(want.numpy(), full.numpy(), rtol=TOL,
                                   atol=TOL)


def test_width_cases_walk_the_order():
    """The card's small cases at every lane width (``width_cases``, made
    here on the CPU): the kernel's decomposition gives the in-order bits,
    whole and in windows, and the windows concatenate to the whole."""
    whole = {}
    for name, g, i, o, mode, R, dt, lo, hi in tbwd.width_cases(3, "cpu"):
        want = tbwd.in_order_backward(g, i, o, mode, R, dt, row_lo=lo,
                                      row_hi=hi)
        assert torch.equal(kernel_mirror(g, i, o, mode, R, dt, lo, hi),
                           want), name
        key = (g.shape[1], dt, mode)
        whole.setdefault(key, []).append(want)
    for parts in whole.values():
        assert torch.equal(torch.cat(parts[1:]), parts[0])


def test_chunk_matches_the_kernel_plan():
    """The order's chunk is the plan's."""
    assert tbwd.CHUNK == teb.BWD_CHUNK


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_in_order_matches_jax_grad(mode):
    """Within 1e-5 of the JAX package's gradient of its bag (``take``
    with clipping, then ``segment_sum``; positions outside every bag get
    segment ids past ``num_bags``)."""
    R = 700
    g, idx, off = _case(5, R, D=10, B=120, hot=300)
    i, o = idx.numpy(), off.numpy()
    B = o.shape[0] - 1
    pos = np.arange(i.shape[0])
    seg = np.searchsorted(o[1:], pos, side="right")
    seg = np.where((pos >= o[0]) & (pos < o[-1]), seg, B + 5)
    table = np.zeros((R, 10), np.float32)

    def jbag(t):
        rows = jnp.clip(jnp.asarray(i), 0, R - 1)
        return JR.embedding_bag(t, rows, jnp.asarray(seg, jnp.int32), B,
                                mode)
    want = jax.grad(lambda t: jnp.sum(jbag(t) * g.numpy()))(
        jnp.asarray(table))
    got = tbwd.in_order_backward(g, idx, off, mode, R, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
