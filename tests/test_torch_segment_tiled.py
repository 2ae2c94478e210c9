"""Port vs reference: the warp walk of the two frozen-segment kernels.

``csrc/segment_decode.cuh`` (``frozen_walk``) is the one body of the
``segment_intersect`` and ``scored_intersect`` CUDA kernels.  Warps of a
persistent grid take items in rounds: strips of a dense row's a-blocks,
one live a-block of a sparse row (or a quarter of its lanes when b has
many blocks per a-block), or a share of the pad blocks; lane i decodes
docids 4i..4i+3 from the words that hold their gaps plus a five-step
warp scan.  An a-block whose docids all fall in the range of the b-block
decoded last goes straight to it; otherwise a probe at the warp's
previous end, or a 32-way search of b's block firsts, bounds the window
of b-blocks it can touch, each docid finds its block in the window (a
staged window, or a sampled one when it is wider than a block), and the
runs of docids that share a block are visited in order, the last
decoded block kept; a short run matches by ballot, a long one by a
search of the staged block; pad and skipped a-blocks are written as
zeros.

Here :func:`mirror_walk`, a numpy transcription of that walk, is held on
the CPU against the JAX package's oracles
(``repro.kernels.ref.segment_intersect_mask_batched_ref``,
``scored_intersect_batched_ref``), the Pallas kernels in interpret mode
at one case each, and the port's plain versions, on the edge cases every
card check of the kernels uses (``launch.time_segment_intersect``), at
several strip lengths, grid sizes and launch plans (a warp's kept block
and hint carry across its items), and on random sets.  Integer outputs,
exact equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import segment_intersect as jsi
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segment_intersect as tsi
from repro_torch.launch import time_segment_intersect as tsg

INVALID = 0xFFFFFFFF
M32 = 0xFFFFFFFF
SEG = 128
CASES = [name for name, _, _, _ in tsg.edge_lists()]
# (strip, warps, parts per row): a-blocks per dense-row item, warps in the
# grid, and the launcher's plan for a call smaller than the grid (single
# a-blocks, four parts an a-block)
WALKS = [(1, 1, None), (4, 8, None), (3, 5, None), (1, 6, "split")]


# ---------------------------------------------------------------------------
# the mirror
# ---------------------------------------------------------------------------
def _words(pay, pw, woff, bw):
    """[32, 4] words holding each lane's four gaps; out of range -> 0."""
    lane = np.arange(32)[:, None]
    if bw == 1:
        idx = np.concatenate([woff + lane, np.full((32, 3), -1)], 1)
    elif bw == 2:
        idx = np.concatenate([woff + 2 * lane + np.arange(2),
                              np.full((32, 2), -1)], 1)
    else:
        idx = woff + 4 * lane + np.arange(4)
    ok = (idx >= 0) & (idx < pw)
    return np.where(ok, pay[np.clip(idx, 0, max(pw - 1, 0))], 0).astype(
        np.int64)


def _decode4(first, bw, w):
    """[32, 4] docids (position 4 lane + k): first + the block's scan."""
    v = w & M32
    if bw == 1:
        g = (v[:, :1] >> (8 * np.arange(4))) & 0xFF
    elif bw == 2:
        g = np.stack([v[:, 0] & 0xFFFF, v[:, 0] >> 16, v[:, 1] & 0xFFFF,
                      v[:, 1] >> 16], 1)
    else:
        g = v
    s = np.cumsum(g, 1) & M32                  # in-lane sums
    inc = np.cumsum(s[:, 3]) & M32             # the warp's inclusive scan
    base = (int(first) + inc - s[:, 3]) & M32
    return (base[:, None] + s) & M32


def _search_round(f, x, lo, ln):
    if ln <= 32:
        return lo, ln
    step = (ln + 31) >> 5
    idx = lo + (np.arange(32) + 1) * step - 1
    le = [(i < lo + ln) and int(f[i]) <= x for i in idx]
    c = int(sum(le))
    hi = min(lo + (c + 1) * step - 1, lo + ln)
    return lo + c * step, hi - (lo + c * step)


def _search_last(f, x, lo, ln):
    return lo + sum(int(f[lo + i]) <= x for i in range(min(ln, 32)))


def _upper2(f, x0, x1, h):
    """U(x) = #{firsts <= x} for the window's two ends, as the kernel
    finds them: a probe of 32 entries from h - 1, then 32-way rounds."""
    n = f.size
    lo0 = lo1 = 0
    ln0 = ln1 = n
    if h > 0 or n <= 31:
        i = h - 1 + np.arange(32)
        fv = np.array([0 if k < 0 else (int(f[k]) if k < n else INVALID)
                       for k in i])
        c0, c1 = int((fv <= x0).sum()), int((fv <= x1).sum())
        if 1 <= c0 < 32:
            lo0, ln0 = h - 1 + c0, 0
        if 1 <= c1 < 32:
            lo1, ln1 = h - 1 + c1, 0
    while ln0 > 32 or ln1 > 32:
        lo0, ln0 = _search_round(f, x0, lo0, ln0)
        lo1, ln1 = _search_round(f, x1, lo1, ln1)
    u0 = _search_last(f, x0, lo0, ln0) if ln0 > 0 else lo0
    u1 = _search_last(f, x1, lo1, ln1) if ln1 > 0 else lo1
    return u0, u1


def _lift(get, n, x, strict):
    """Binary lifting over an ascending sequence of length n: the count
    of entries <= x (or < x with ``strict``), as the kernel's loops."""
    c, step = 0, 1
    while step * 2 <= n:
        step *= 2
    while step >= 1:
        if c + step <= n:
            v = int(get(c + step - 1))
            if (v < x) if strict else (v <= x):
                c += step
        step >>= 1
    return c


def _count_le128(win, x):
    c = 0
    for step in (64, 32, 16, 8, 4, 2, 1):
        if int(win[c + step - 1]) <= x:
            c += step
    return c + (c == SEG - 1 and int(win[SEG - 1]) <= x)


def _lower127(bv, x):
    c = 0
    for step in (64, 32, 16, 8, 4, 2, 1):
        if int(bv[c + step - 1]) < x:
            c += step
    return c


SPLIT, SPLIT_RATIO = 4, 16


def item_blocks(s, nba, parts, na, nbv, strip):
    """The a-blocks [b, e) of item (row, part s) and the lanes [l0, l1)
    whose docids it owns: strips of ``strip`` a-blocks, or for a sparse
    row (b's blocks outnumber twice its live a-blocks, with parts to
    spare) one live a-block per part, a quarter of one when b has more
    than 16 blocks a live a-block, and the pad blocks shared by the
    rest."""
    live = min(-(-na // SEG), nba)
    bblocks = -(-nbv // SEG)
    g = SPLIT if (bblocks > SPLIT_RATIO * live
                  and 2 * SPLIT * live <= parts) else 1
    if bblocks > 2 * live and 2 * live * g <= parts:
        used = live * g
        if s < used:
            l0 = (s % g) * (32 // g) if g > 1 else 0
            return s // g, s // g + 1, l0, l0 + 32 // g
        per = -(-(nba - live) // (parts - used))
        b = min(live + (s - used) * per, nba)
        return b, min(b + per, nba), 0, 32
    b = min(s * strip, nba)
    return b, min(b + strip, nba), 0, 32


def test_items_cover_every_block_once():
    for nba, na, nbv, strip, parts in [
            (1, 5, 900, 4, 1), (4096, 900, 5000, 4, 1024),
            (65536, 3365, 4613510, 4, 16384), (7, 0, 10, 2, 4),
            (64, 8191, 200, 3, 22), (9, 1100, 100000, 1, 9),
            (65536, 13, 1676157, 4, 16384), (256, 300, 9000, 4, 64),
            (65536, 503229, 4194892, 4, 16384), (1, 9, 7227, 1, 4),
            (8, 855, 5300, 1, 32), (512, 33085, 9000, 1, 2048)]:
        seen = np.zeros((nba, 32), int)
        for s in range(parts):
            b, e, l0, l1 = item_blocks(s, nba, parts, na, nbv, strip)
            seen[b:e, l0:l1] += 1
        assert (seen == 1).all(), (nba, na, nbv, strip)


def _runs(f, x, va, hint, jmax, tr):
    """The general path: the window's ends, each docid's block, the
    runs; returns (j, run_p, run_j, hint)."""
    mn, mx = int(x[va].min()), int(x[va].max())
    ulo, uhi = _upper2(f, mn, mx, hint)
    hint = uhi
    wn = uhi - ulo
    xs = x.reshape(-1)
    if wn == 0:
        U = np.full(SEG, ulo)
    elif wn < SEG:
        win = np.full(SEG, INVALID, np.int64)
        win[:wn] = f[ulo: uhi]
        U = np.array([ulo + _count_le128(win, int(v))
                      for v in xs])
        tr["window"] = tr.get("window", 0) + 1
    else:
        # 128 equal parts; each part's last entry staged
        P = [(i * wn) >> 7 for i in range(SEG + 1)]
        smp = np.array([f[ulo + P[i + 1] - 1]
                        for i in range(SEG)])
        U = []
        for v in xs:
            pk = _count_le128(smp, int(v))
            c = P[pk]
            ln = P[pk + 1] - 1 - c if pk < SEG else 0
            U.append(ulo + c + _lift(
                lambda i: f[ulo + c + i], ln, int(v), False))
        U = np.array(U)
        tr["wide"] = tr.get("wide", 0) + 1
    j = np.where(va.reshape(-1), np.minimum(U - 1, jmax), -1)
    prev = np.r_[np.iinfo(np.int64).min, j[:-1]]
    starts = np.nonzero((j >= 0) & (j != prev))[0]
    run_p = list(starts) + [SEG]
    run_j = [int(j[p]) for p in starts]
    return j, run_p, run_j, hint


class _Warp:
    """One warp's state across its items: the last decoded b-block."""

    def __init__(self):
        self.k_row, self.k_j, self.s_j = -1, -1, -1
        self.k_lo, self.k_hi = 0, 0         # docids that map to the block
        self.kv = np.full(SEG, INVALID, np.int64)
        self.ksw = np.zeros(32, np.int64)


def mirror_walk(a, b, rest=None, th=None, *, strip=4, warps=8,
                parts=None, ballot_max=2, trace=None):
    """The kernel's walk over numpy stacks ``a``/``b`` (StackedLists, or
    ScoredStack with ``rest``/``th``): int32[rows, nba * 128].  Every
    lane is written exactly once (checked).  ``trace``, a dict, collects
    which branches ran."""
    scored = rest is not None
    A, B = (a.ids, b.ids) if scored else (a, b)
    rows, nba = A.firsts.shape
    nbb = B.firsts.shape[1]
    u = lambda z: np.asarray(z).astype(np.int64)          # noqa: E731
    af, abw, awo, apay, ans = (u(A.firsts), u(A.bws), u(A.woffs),
                               u(A.payload), u(A.ns))
    bf, bbw, bwo, bpay, bns = (u(B.firsts), u(B.bws), u(B.woffs),
                               u(B.payload), u(B.ns))
    if scored:
        asw = u(a.swords).reshape(rows, nba, 32)
        bsw = u(b.swords).reshape(rows, nbb, 32)
        amax = u(a.bmax)
    pwa, pwb = apay.shape[1], bpay.shape[1]
    tr = trace if trace is not None else {}
    out = np.full((rows, nba * SEG), -7, np.int64)
    parts = parts or -(-nba // strip)
    pos = 4 * np.arange(32)[:, None] + np.arange(4)          # [32, 4]
    items = rows * parts
    for gw in range(warps):
        wp = _Warp()
        for k in range(-(-items // warps)):
            t = k * warps + (gw + k) % warps
            if t >= items:
                continue
            r = t % rows
            na, nbv = int(ans[r]), int(bns[r])
            ib, ie, l0, l1 = item_blocks(t // rows, nba, parts, na, nbv,
                                         strip)
            own = np.zeros((32, 1), bool)
            own[l0:l1] = True
            tr["sparse_items"] = tr.get("sparse_items", 0) + (
                ie - ib == 1 and ib * SEG < na and strip > 1)
            tr["split_items"] = tr.get("split_items", 0) + (l1 - l0 < 32)
            jmax = (nbv - 1) // SEG if nbv > 0 else 0
            hint = 0
            for ia in range(ib, ie):
                o = slice(ia * SEG, (ia + 1) * SEG)
                live = ia * SEG < na
                if scored and live:
                    bound = (int(amax[r, ia]) + int(rest[r])) & M32
                    bound -= (bound >> 31) << 32          # wrap to int32
                    live = bound > int(th[r])
                    tr["skipped"] = tr.get("skipped", 0) + (not live)
                if not live:
                    out[r, o] = np.where(own, 0, out[r, o].reshape(32, 4)
                                         ).reshape(-1)
                    tr["pad"] = tr.get("pad", 0) + 1
                    continue
                x = _decode4(af[r, ia], int(abw[r, ia]),
                             _words(apay[r], pwa, int(awo[r, ia]),
                                    int(abw[r, ia])))
                va = own & (ia * SEG + pos < na) & (x != INVALID)
                res = np.zeros((32, 4), np.int64)
                aimp = ((asw[r, ia][:, None] >> (8 * np.arange(4))) & 0xFF
                        if scored else None)
                if va.any() and nbv > 0 and nbb > 0:
                    mn, mx = int(x[va].min()), int(x[va].max())
                    f = bf[r] & M32
                    xs = x.reshape(-1)
                    if wp.k_row == r and wp.k_lo <= mn and mx < wp.k_hi:
                        # every docid maps to the kept block
                        j = np.where(va.reshape(-1), wp.k_j, -1)
                        hint = wp.k_j + 1
                        run_p, run_j = [0, SEG], [wp.k_j]
                        tr["fast"] = tr.get("fast", 0) + 1
                    else:
                        j, run_p, run_j, hint = _runs(
                            f, x, va, hint, jmax, tr)
                    for s, J in enumerate(run_j):
                        need = (not (wp.k_row == r and wp.k_j == J)
                                if s == 0 else J != run_j[s - 1])
                        if need:
                            blk = (int(bbw[r, J]), int(bwo[r, J]))
                            v = _decode4(bf[r, J], blk[0],
                                         _words(bpay[r], pwb, blk[1],
                                                blk[0])).reshape(-1)
                            wp.kv = np.where(J * SEG + np.arange(SEG) < nbv,
                                             v, INVALID)
                            if scored:
                                wp.ksw = bsw[r, J]
                            wp.k_row, wp.k_j, wp.s_j = r, J, -1
                            wp.k_lo = int(bf[r, J]) & M32
                            wp.k_hi = (1 << 32 if J >= jmax or J + 1 >= nbb
                                       else int(bf[r, J + 1]) & M32)
                            tr["decodes"] = tr.get("decodes", 0) + 1
                        else:
                            tr["kept"] = tr.get("kept", 0) + 1
                        p0, p1 = run_p[s], run_p[s + 1]
                        bimps = ((wp.ksw[:, None] >> (8 * np.arange(4)))
                                 & 0xFF).reshape(-1)
                        if p1 - p0 <= ballot_max:
                            tr["ballot"] = tr.get("ballot", 0) + 1
                            for p in range(p0, p1):
                                if j[p] != J:
                                    continue
                                hits = np.nonzero(wp.kv == xs[p])[0]
                                if hits.size:
                                    val = 1
                                    if scored:
                                        bi = int(bimps[hits[0]])
                                        val = (int(aimp.reshape(-1)[p]) + bi
                                               if bi > 0 else 0)
                                    res.reshape(-1)[p] = val
                        else:
                            tr["searched"] = tr.get("searched", 0) + 1
                            wp.s_j = J
                            for p in np.nonzero(j == J)[0]:
                                lo = _lower127(wp.kv, int(xs[p]))
                                if wp.kv[lo] == xs[p]:
                                    val = 1
                                    if scored:
                                        bi = int(bimps[lo])
                                        val = (int(aimp.reshape(-1)[p]) + bi
                                               if bi > 0 else 0)
                                    res.reshape(-1)[p] = val
                out[r, o] = np.where(own, res, out[r, o].reshape(32, 4)
                                     ).reshape(-1)
    assert (out != -7).all(), "a lane was never written"
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# inputs and oracles
# ---------------------------------------------------------------------------
def _case(name):
    return next((ra, rb, nb) for n, ra, rb, nb in tsg.edge_lists()
                if n == name)


def _np_stacks(name):
    ra, rb, nb = _case(name)
    pa = [tsi.pack_docids(x) for x in ra]
    na = nb or tsi._pow2(max([p.n_blocks for p in pa] + [1]))
    return (tsi.stack_packed(pa, n_blocks=na),
            tsi.stack_packed([tsi.pack_docids(x) for x in rb]))


def _jstack(s):
    return jsi.StackedLists(*[jnp.asarray(getattr(s, f))
                              for f in jsi.StackedLists._fields])


def _jscored(s):
    return jsi.ScoredStack(ids=_jstack(s.ids), swords=jnp.asarray(s.swords),
                           bmax=jnp.asarray(s.bmax))


def _scored_np(name):
    """The scored edge cases of ``name`` as numpy stacks, rest and th
    (the card checks' own inputs, made on the CPU)."""
    out = []
    for n, A, B, rest, th in tsg.scored_edge_cases(tsi, device="cpu"):
        if n.rsplit(", th ", 1)[0] == name:
            out.append((n.rsplit(", th ", 1)[1], _host_scored(A),
                        _host_scored(B), rest.numpy(), th.numpy()))
    return out


def _host_scored(s):
    """A torch ScoredStack back to numpy leaves in the reference's
    dtypes (uint32 firsts, payload and score words)."""
    ids = s.ids
    return tsi.ScoredStack(
        ids=tsi.StackedLists(firsts=ids.firsts.numpy().astype(np.uint32),
                             bws=ids.bws.numpy(), woffs=ids.woffs.numpy(),
                             payload=ids.payload.numpy().astype(np.uint32),
                             ns=ids.ns.numpy()),
        swords=s.swords.numpy().astype(np.uint32), bmax=s.bmax.numpy())


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
def test_edge_cases_reach_every_branch():
    """Across the edge cases the walk takes every branch: pad blocks,
    windows staged and searched in device memory, decodes and kept
    blocks, ballot-matched and searched runs; and byte widths 1, 2, 4."""
    tr = {}
    widths = set()
    for name in CASES:
        a, b = _np_stacks(name)
        mirror_walk(a, b, trace=tr)
        widths |= set(np.asarray(a.bws).ravel().tolist())
    for key in ("pad", "window", "wide", "decodes", "kept", "ballot",
                "searched", "sparse_items", "split_items", "fast"):
        assert tr.get(key, 0) > 0, (key, tr)
    assert {1, 2, 4} <= widths
    # an a-block that needs 128 distinct b-blocks: 128 runs, one decode each
    tr = {}
    a, b = _np_stacks("128 distinct b-blocks")
    mirror_walk(a, b, trace=tr)
    assert tr["decodes"] == SEG and tr["ballot"] == SEG
    tr = {}
    a, b = _np_stacks("many a-blocks on one b-block")
    mirror_walk(a, b, strip=4, warps=1, trace=tr)
    assert tr["decodes"] == 1 and tr["kept"] > 100


def _parts(how, nba):
    return 4 * nba if how == "split" else None


@pytest.mark.parametrize("strip,warps,how", WALKS)
@pytest.mark.parametrize("name", CASES)
def test_mirror_matches_oracle(name, strip, warps, how):
    a, b = _np_stacks(name)
    want = np.asarray(jref.segment_intersect_mask_batched_ref(
        _jstack(a), _jstack(b)))
    got = mirror_walk(a, b, strip=strip, warps=warps,
                      parts=_parts(how, a.firsts.shape[1]))
    np.testing.assert_array_equal(got, want)
    plain = ops.segment_intersect_mask_batched(a.to("cpu"), b.to("cpu"))
    np.testing.assert_array_equal(plain.numpy(), want)


@pytest.mark.parametrize("name", CASES)
def test_single_pair_mirror_matches_oracle(name):
    """The single-pair kernel runs the walk as one row, each list at its
    own block count and payload width."""
    ra, rb, _ = _case(name)
    for x, y in zip(ra, rb):
        if not x.size:
            continue
        pa, pb = tsi.pack_docids(x), tsi.pack_docids(y)
        want = np.asarray(jref.segment_intersect_mask_ref(
            jsi.pack_docids(x), jsi.pack_docids(y)))
        np.testing.assert_array_equal(
            ops.segment_intersect_mask(pa.to("cpu"), pb.to("cpu")).numpy(),
            want)
        if pb.n_blocks == 0:        # the wrapper answers without a launch
            assert not want.any()
            continue
        for strip, warps, how in WALKS:
            got = mirror_walk(tsi.stack_packed([pa]), tsi.stack_packed([pb]),
                              strip=strip, warps=warps,
                              parts=_parts(how, pa.n_blocks))
            np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("strip,warps,how", WALKS)
@pytest.mark.parametrize("name", CASES)
def test_scored_mirror_matches_oracle(name, strip, warps, how):
    """At the three thresholds, with impacts of 255 + 255, b lanes whose
    impact is 0 (a hit there gives 0) and a bound that wraps in int32."""
    for tname, A, B, rest, th in _scored_np(name):
        want = np.asarray(jref.scored_intersect_batched_ref(
            _jscored(A), _jscored(B), jnp.asarray(rest), jnp.asarray(th)))
        got = mirror_walk(A, B, rest, th, strip=strip, warps=warps,
                          parts=_parts(how, A.ids.firsts.shape[1]))
        np.testing.assert_array_equal(got, want, err_msg=tname)
        args = (A.to("cpu"), B.to("cpu"), torch.as_tensor(rest),
                torch.as_tensor(th))
        np.testing.assert_array_equal(
            tref.scored_intersect_batched_ref(*args).numpy(), want)


def test_scored_edge_cases_cover_their_claims():
    """Hits summing to 510, member docids that score 0 (b's impact 0),
    a row whose bound wraps and is skipped, every threshold."""
    sums, zero_b, wrapped, names = set(), 0, 0, set()
    for name in CASES:
        for tname, A, B, rest, th in _scored_np(name):
            got = mirror_walk(A, B, rest, th)
            sums |= set(np.unique(got).tolist())
            hits = tref.segment_intersect_mask_batched_ref(
                A.ids.to("cpu"), B.ids.to("cpu")).numpy().astype(bool)
            if tname == "none":
                zero_b += int((hits & (got == 0)).sum())
                if len(rest) > 1 and hits[1].any():
                    wrapped += not got[1].any()
            if tname == "all":
                assert not got.any(), name
            names.add(tname)
    assert 510 in sums and zero_b > 0 and wrapped > 0
    assert names == {"none", "half", "all"}


def test_pallas_interpret_matches_mirror():
    """The JAX package's Pallas kernels in interpret mode, once each."""
    a, b = _np_stacks("bw 1, 2 and 4 in one row")
    want = np.asarray(jsi.segment_intersect_mask_batched(
        _jstack(a), _jstack(b), interpret=True))
    np.testing.assert_array_equal(mirror_walk(a, b, strip=1, warps=2), want)
    ra, rb, _ = _case("part-filled last blocks")
    want = np.asarray(jsi.segment_intersect_mask(
        jsi.pack_docids(ra[0]), jsi.pack_docids(rb[0]), interpret=True))
    got = mirror_walk(tsi.stack_packed([tsi.pack_docids(ra[0])]),
                      tsi.stack_packed([tsi.pack_docids(rb[0])]))
    np.testing.assert_array_equal(got[0], want)
    (_, A, B, rest, th), = [c for c in _scored_np("ns = 0 rows")
                            if c[0] == "none"]
    want = np.asarray(jops.scored_intersect_batched(
        _jscored(A), _jscored(B), jnp.asarray(rest), jnp.asarray(th),
        use_kernel=True, interpret=True))
    np.testing.assert_array_equal(mirror_walk(A, B, rest, th), want)


def test_phase2_inputs_match_the_smoke_lists():
    """The yardstick's phase-2 rows are ``chip_smoke.py``'s (one
    generator, the same draws), here at a 2**14-tweet segment."""
    rng = np.random.default_rng(tsg.LISTS_SEED)
    la = tsg.segment_lists(rng, 1 << 14, tsg.DENS_A)
    lb = tsg.segment_lists(rng, 1 << 14, tsg.DENS_B)
    sa, sb, a1, b1, sca, scb, rest, ths = tsg.phase2_inputs(
        tsi, n_docs=1 << 14, device="cpu")
    np.testing.assert_array_equal(
        tsi.decode_stacked(sa).numpy()[0, : la[0].size], la[0])
    assert [int(n) for n in sb.ns] == [x.size for x in lb]
    assert a1.n == la[tsg.SINGLE[0]].size and b1.n == lb[tsg.SINGLE[1]].size
    got = ops.scored_intersect_batched(sca, scb, rest, ths["half"])
    np.testing.assert_array_equal(
        got.numpy(), mirror_walk(_host_scored(sca), _host_scored(scb),
                                 rest.numpy(), ths["half"].numpy()))


_sets = st.lists(st.integers(0, 5000), max_size=700).map(
    lambda v: np.unique(np.asarray(v, np.int64)).astype(np.uint32))


@settings(max_examples=25, deadline=None)
@given(a=_sets, b=_sets, strip=st.sampled_from([1, 2, 3]),
       warps=st.sampled_from([1, 2, 5]))
def test_mirror_property(a, b, strip, warps):
    """Random ascending sets: the mirror equals the port's plain version
    (itself held to the JAX oracle above) at any strip and grid."""
    sa = tsi.stack_packed([tsi.pack_docids(a)])
    sb = tsi.stack_packed([tsi.pack_docids(b)])
    want = tref.segment_intersect_mask_batched_ref(sa.to("cpu"),
                                                   sb.to("cpu")).numpy()
    np.testing.assert_array_equal(
        mirror_walk(sa, sb, strip=strip, warps=warps), want)
