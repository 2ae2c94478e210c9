"""Time one checkout's frozen-segment kernels (``segment_intersect_mask``,
``segment_intersect_mask_batched`` and ``scored_intersect_batched``) with
this checkout's timers, so two checkouts timed in one call share one
yardstick.

    python src/repro_torch/launch/time_segment_intersect.py [--root DIR] \
        [--calls FILE]

``DIR`` (this checkout by default) is the root of the checkout whose
``src/repro_torch`` is imported and whose kernels are built, into its own
``_build``; the timers always come from this file's checkout
(``kernels/timing.py``, loaded by path).  To compare a parent commit with
a change, unpack the parent into a directory that ``.gitignore`` lists
and run parent, change, change, parent in one job on one card.

Shapes (``chip_smoke.py`` phase 2's, from the same seed): eight
(query, segment) rows over a 2**23-tweet segment, a at densities
``DENS_A`` against b at ``DENS_B`` (head, torso and tail terms, a pad row
and an empty b), stacked at NB = 65,536 blocks: the batched call; the
single pair (row 0's a against row 2's b); the scored call on the same
rows with impacts at three thresholds (none skipped, about half, all);
then each row of the batched and scored calls alone (the same NB and
payload width) and an all-pad stack of the same shape (every ``ns`` 0),
which split the call's time by row.  For each it prints one JSON line:
the kernel warm (``ms``), each launch alone after the L2 is overwritten
(``ms_cold``) and by the profiler (``device_ms``); the bound (``bytes``:
:func:`batched_bytes`, :func:`scored_bytes`, over 3.35 TB/s); whether two
calls equal the checkout's plain version bit for bit; and the SHA-256 of
the output, which two checkouts share when their outputs are identical.

``--calls FILE`` adds the calls the path really made, as
``chip_smoke.py --segment-calls FILE`` saves them: phase 3's eight
``segment_intersect_mask_batched`` and eight ``scored_intersect_batched``
calls and phase 4's 25 ``segment_intersect_mask`` calls, one line each.
It exits 1 if any check fails.

This module also holds what every check of the two kernels uses: the
phase-2 lists (:func:`segment_lists`), the byte counts of the bounds, the
split threshold (:func:`split_threshold`) and the edge cases
(:func:`edge_lists`, :func:`edge_stacks`, :func:`scored_edge_cases`).  It
imports nothing but torch and numpy at its top.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve()
INVALID = 0xFFFFFFFF
SEG = 128                          # docids per compressed block
HBM_BYTES_PER_S = 3.35e12
SEG_DOCS = 1 << 23                 # Earlybird's segment
LISTS_SEED = 5                     # phase 2's generator seed
# phase 2's rows: a query batch's driving pairs (a head term, torso and
# tail terms, a pad row; an empty b); densities give bw 1, 2 and 4 blocks
DENS_A = (0.55, 0.06, 0.004, 0.0004, 3e-5, 2e-6, 0.0, 0.3)
DENS_B = (0.3, 0.5, 0.02, 0.55, 0.001, 0.2, 0.4, 0.0)
SINGLE = (0, 2)                    # the single pair: a row 0, b row 2


def _timing():
    spec = importlib.util.spec_from_file_location(
        "_kernel_timing", HERE.parent.parent / "kernels" / "timing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------
def segment_lists(rng, n_docs: int, densities):
    """Ascending uint32 docid sets of the given densities over one
    segment (an empty set at density 0)."""
    out = []
    for p in densities:
        if p <= 0:
            out.append(np.zeros(0, np.uint32))
            continue
        m = rng.random(n_docs) < p
        out.append(np.nonzero(m)[0].astype(np.uint32))
    return out


def split_threshold(bound: np.ndarray, n_real: int) -> int:
    """The threshold that skips the share of a row's real blocks closest
    to one half (a block survives when its bound exceeds it)."""
    real = bound[:n_real]
    if real.size == 0:
        return -1
    cands = np.unique(real)
    skip = np.array([(real <= c).mean() for c in cands])
    return int(cands[np.argmin(np.abs(skip - 0.5))])


def thresholds(bmax: np.ndarray, rest: np.ndarray, ns: np.ndarray):
    """``{"none", "half", "all"}`` -> th int32[rows]: no block skipped,
    about half of each row's real blocks, every block (bounds taken
    without wrapping, thresholds clipped into int32)."""
    bound = bmax.astype(np.int64) + rest.astype(np.int64)[:, None]
    nreal = -(-ns.astype(np.int64) // SEG)
    half = [split_threshold(bound[r], nreal[r]) for r in range(len(rest))]
    return {k: np.clip(v, -1, 2 ** 31 - 1).astype(np.int32) for k, v in (
        ("none", np.full(len(rest), -1)), ("half", np.array(half)),
        ("all", bound.max(1) + 1))}


def _u32(x) -> np.ndarray:
    return np.unique(np.asarray(x, np.int64)).astype(np.uint32)


def edge_lists(seed: int = 0):
    """``(name, a_rows, b_rows, n_blocks)`` cases of ascending docid sets
    for the two kernels: rows of a and b (numpy uint32), and the stacks'
    shared block count (None: the next power of two).

    They reach every branch of the warp walk: docids equal to a
    b-block's first and last docid and in the gap between two blocks;
    an a-block that needs 128 distinct b-blocks, a window of b-blocks
    wider than one block, and a-blocks that need none (below b's first
    docid) or only b's last block (above its last docid); many a-blocks
    on one b-block; bw 1, 2 and 4 in one row; part-filled last blocks;
    ``ns = 0`` rows and an all-empty b; NB = 1 and a wide NB of pad
    blocks; one row and 64 rows; the docids 0, 0xFFFFFFFE and INVALID
    itself (a real docid that must give 0)."""
    rng = np.random.default_rng(seed)
    bstep = np.concatenate([100 + 10000 * k + 2 * np.arange(SEG)
                            for k in range(6)])
    probes = [0, 5, 99]
    for k in range(6):
        lo = 100 + 10000 * k
        probes += [lo, lo + 1, lo + 2 * SEG - 2, lo + 2 * SEG - 1,
                   lo + 600, lo + 9999, lo + 10 * k + 4]
    probes += [60100, 60254, 70000, 10 ** 6]
    # b-blocks of 256 docids each; one a-docid in each of 128 of them
    dense_b = np.arange(0, 2 * SEG * SEG, 2)
    one_each = np.arange(SEG) * 2 * SEG + np.arange(SEG) % 5
    wide_b = np.setdiff1d(np.arange(200_000), np.arange(0, 200_000, 3))
    sparse_b = np.arange(100) * 1000
    mixed = np.concatenate([np.arange(SEG), 1000 + np.arange(SEG) * 300,
                            100_000 + np.arange(SEG) * 70_000,
                            9_100_000 + np.arange(40)])
    mixed_b = np.concatenate([mixed[::2], mixed[1::3] + 1,
                              np.arange(200, 5000, 7)])
    top = [0, 1, 2, 0xFFFFFFFD, 0xFFFFFFFE, 0xFFFFFFFF]
    r64a = [_u32(rng.integers(0, s, n)) for n, s in
            zip(rng.integers(0, 3000, 64), rng.choice([500, 70_000, 1 << 22,
                                                       1 << 31], 64))]
    r64b = [_u32(np.concatenate([x[::2], rng.integers(0, 1 << 22, n)]))
            for x, n in zip(r64a, rng.integers(0, 3000, 64))]
    r64b[5] = np.zeros(0, np.uint32)
    return [
        ("first, last and gap", [_u32(probes)], [_u32(bstep)], None),
        ("128 distinct b-blocks", [_u32(one_each)], [_u32(dense_b)], None),
        ("window wider than a block",
         [_u32(rng.choice(200_000, 700, replace=False))], [_u32(wide_b)],
         None),
        ("a below b", [_u32(np.arange(0, 500, 3))],
         [_u32(1000 + np.arange(0, 4000, 2))], None),
        ("a above b", [_u32(5000 + np.arange(0, 900, 3))],
         [_u32(np.arange(0, 4000, 2))], None),
        ("many a-blocks on one b-block", [_u32(np.arange(0, 99_000, 7))],
         [_u32(sparse_b)], None),
        ("bw 1, 2 and 4 in one row", [_u32(mixed)], [_u32(mixed_b)], None),
        ("part-filled last blocks", [_u32(np.arange(300) * 3)],
         [_u32(np.arange(1000) * 2)], None),
        ("ns = 0 rows",
         [np.zeros(0, np.uint32), _u32(np.arange(400) * 5),
          np.zeros(0, np.uint32)],
         [_u32(np.arange(300) * 2), np.zeros(0, np.uint32),
          np.zeros(0, np.uint32)], None),
        ("empty b", [_u32(np.arange(500)), _u32(np.arange(9) * 11)],
         [np.zeros(0, np.uint32)] * 2, None),
        ("NB = 1", [_u32(np.arange(0, 120, 2)), _u32([7])],
         [_u32(np.arange(0, 128, 3)), _u32([7])], None),
        ("wide NB of pad blocks",
         [_u32(rng.integers(0, 1 << 20, 900)), _u32(np.arange(0, 4000, 3))],
         [_u32(rng.integers(0, 1 << 20, 5000)), _u32(np.arange(0, 4000, 2))],
         4096),
        ("one row", [_u32(rng.integers(0, 50_000, 3000))],
         [_u32(rng.integers(0, 50_000, 9000))], None),
        ("64 rows", r64a, r64b, None),
        ("extreme docids", [_u32(top), _u32(top[:-1])],
         [_u32(top), _u32(top)], None),
    ]


def edge_stacks(si, seed: int = 0, device="cuda"):
    """``(name, a, b)`` StackedLists pairs on ``device`` from
    :func:`edge_lists` (``si``: the checkout's
    ``repro_torch.kernels.segment_intersect``)."""
    out = []
    for name, ra, rb, nb in edge_lists(seed):
        pa = [si.pack_docids(x) for x in ra]
        pb = [si.pack_docids(x) for x in rb]
        na = nb or si._pow2(max([p.n_blocks for p in pa] + [1]))
        out.append((name, si.stack_packed(pa, n_blocks=na).to(device),
                    si.stack_packed(pb).to(device)))
    return out


def edge_pairs(si, seed: int = 0, device="cuda"):
    """``(name, a, b)`` PackedList pairs (the single-pair kernel): each
    case's rows where a is not empty, b as packed (possibly empty)."""
    return [(f"{name} row {i}", si.pack_docids(x).to(device),
             si.pack_docids(y).to(device))
            for name, ra, rb, _ in edge_lists(seed)
            for i, (x, y) in enumerate(zip(ra, rb)) if x.size]


def scored_edge_cases(si, seed: int = 0, device="cuda"):
    """``(name, a, b, rest, th)`` ScoredStack cases on ``device``: the
    edge lists with impacts in [1, 255] (a quarter of them 255, so hits
    sum to 510), some of b's valid lanes' impacts zeroed (a hit there
    gives 0), rest up to 300 and one row's rest near 2**31 (the bound
    wraps in int32), each at the three thresholds."""
    rng = np.random.default_rng(seed + 1)
    out = []
    for name, ra, rb, nb in edge_lists(seed):
        def scored(x):
            imp = rng.integers(1, 256, x.size)
            imp[rng.random(x.size) < 0.25] = 255
            return si.attach_scores(si.pack_docids(x), imp)
        sa = [scored(x) for x in ra]
        sb = [scored(x) for x in rb]
        na = nb or si._pow2(max([p.ids.n_blocks for p in sa] + [1]))
        A = si.stack_scored(sa, n_blocks=na)
        B = si.stack_scored(sb)
        sw = B.swords.view(np.uint8).reshape(B.swords.shape[0], -1).copy()
        for r, p in enumerate(sb):
            if p.ids.n:
                sw[r, rng.choice(p.ids.n, max(p.ids.n // 5, 1))] = 0
        B = B._replace(swords=sw.reshape(-1).view("<u4").reshape(
            B.swords.shape))
        rows = len(ra)
        rest = rng.integers(0, 300, rows).astype(np.int32)
        if rows > 1:
            rest[1] = 0x7FFFFFF0
        for tname, th in thresholds(A.bmax, rest, A.ids.ns).items():
            out.append((f"{name}, th {tname}", A.to(device), B.to(device),
                        torch.as_tensor(rest, device=device),
                        torch.as_tensor(th, device=device)))
    return out


def phase2_inputs(si, seed: int = LISTS_SEED, n_docs: int = SEG_DOCS,
                  device="cuda"):
    """Phase 2's stacks: ``(sa, sb, a1, b1, sca, scb, rest, ths)`` with
    the same docid lists as ``chip_smoke.py`` phase 2 (one generator from
    ``seed``); impacts here are min(tf, 255) for tf drawn geometric(0.6)
    (phase 2 draws them from its stream's head term instead), rest in
    [0, 8)."""
    rng = np.random.default_rng(seed)
    la = segment_lists(rng, n_docs, DENS_A)
    lb = segment_lists(rng, n_docs, DENS_B)
    pa = [si.pack_docids(x) for x in la]
    pb = [si.pack_docids(x) for x in lb]
    sa, sb = si.stack_packed(pa).to(device), si.stack_packed(pb).to(device)
    a1, b1 = pa[SINGLE[0]].to(device), pb[SINGLE[1]].to(device)

    def impacts(n):
        return np.minimum(rng.geometric(0.6, n), si.SCORE_MAX)
    sca = si.stack_scored([si.attach_scores(p, impacts(p.n)) for p in pa])
    scb = si.stack_scored([si.attach_scores(p, impacts(p.n)) for p in pb])
    rest = rng.integers(0, 8, len(pa)).astype(np.int32)
    ths = {k: torch.as_tensor(v, device=device)
           for k, v in thresholds(sca.bmax, rest, sca.ids.ns).items()}
    return (sa, sb, a1, b1, sca.to(device), scb.to(device),
            torch.as_tensor(rest, device=device), ths)


# ---------------------------------------------------------------------------
# bounds: the bytes each call must move
# ---------------------------------------------------------------------------
def touched_bytes(a_ids, b, extra: int = 0) -> int:
    """Bytes of the distinct b-blocks some valid a-lane can match (the
    kernel's data-dependent reads: block entry + 32*bw int64 words, plus
    ``extra`` bytes per block)."""
    rows, nb = b.firsts.shape
    valid = a_ids != INVALID
    j = torch.searchsorted(b.firsts.contiguous(), a_ids.contiguous(),
                           right=True) - 1
    j = torch.minimum(j, ((b.ns.long() - 1) // SEG)[:, None])
    ok = valid & (j >= 0) & (b.ns[:, None] > 0)
    key = torch.unique((torch.arange(rows, device=a_ids.device)[:, None]
                        * nb + j)[ok])
    bw = b.bws.reshape(-1)[key].long()
    return int((16 + 32 * bw * 8 + extra).sum())


def list_bytes(bws, ns) -> int:
    """Bytes of the real (non-pad) blocks of a stack: block tables plus
    32*bw int64 payload words each."""
    nblk = (ns.long() + SEG - 1) // SEG
    real = (torch.arange(bws.shape[-1], device=bws.device)[None, :]
            < nblk[:, None])
    return int(((16 + 32 * bws.long() * 8) * real).sum())


def batched_bytes(si, a, b) -> int:
    """The membership call's bytes: a's real blocks, the b-blocks a valid
    a-lane can match, the int32 mask over every a-lane."""
    a_ids = si.decode_stacked(a)
    return list_bytes(a.bws, a.ns) + touched_bytes(a_ids, b) \
        + a_ids.numel() * 4


def scored_bytes(si, a, b, th, rest) -> int:
    """Bytes the scored kernel must move: per real a-block its block
    entry and bmax (20 bytes); per live a-block its 32*bw payload and 32
    score words (int64 each); per b-block a live lane can match, its
    block entry, payload and score words; the int32 output."""
    a_ids = si.decode_stacked(a.ids)
    nb = a.ids.firsts.shape[1]
    nblk = (a.ids.ns.long() + SEG - 1) // SEG
    real = torch.arange(nb, device=a_ids.device)[None, :] < nblk[:, None]
    bound = (a.bmax.to(torch.int32) + rest.to(torch.int32)[:, None])
    live = real & (bound > th.to(torch.int32)[:, None])
    a_live = torch.where(live.repeat_interleave(SEG, dim=1), a_ids,
                         torch.full_like(a_ids, INVALID))
    per_live = (32 * a.ids.bws.long() + 32) * 8
    return (int(20 * real.sum()) + int((per_live * live).sum())
            + touched_bytes(a_live, b.ids, extra=32 * 8)
            + a_ids.numel() * 4)


def as_stack(si, p):
    """A torch-leaved PackedList as a one-row StackedLists."""
    return si.StackedLists(
        firsts=p.firsts[None], bws=p.bws[None], woffs=p.woffs[None],
        payload=p.payload[None],
        ns=torch.full((1,), p.n, dtype=torch.int32, device=p.firsts.device))


def single_bytes(si, a, b) -> int:
    if a.n_blocks == 0 or b.n_blocks == 0:
        return a.n_blocks * SEG * 4
    return batched_bytes(si, as_stack(si, a), as_stack(si, b))


# ---------------------------------------------------------------------------
# saved calls (chip_smoke.py --segment-calls)
# ---------------------------------------------------------------------------
def to_host(x):
    """A call's argument with its tensors copied to the host; a
    NamedTuple becomes a dict tagged with its type's name."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if hasattr(x, "_fields"):
        return {"_type": type(x).__name__,
                **{f: to_host(getattr(x, f)) for f in x._fields}}
    return x


def from_host(si, x, device="cuda"):
    """:func:`to_host`'s inverse, with the checkout's classes."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        cls = getattr(si, x["_type"])
        return cls(**{f: from_host(si, x[f], device) for f in cls._fields})
    return x


def save_calls(path, calls) -> int:
    """``calls``: {kernel name: [args as :func:`to_host` gives them]};
    returns the file's size."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    torch.save(calls, path)
    return Path(path).stat().st_size


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
KERNEL_NAMES = {"segment_intersect_mask_batched": "segment_intersect_kernel",
                "segment_intersect_mask": "segment_intersect_kernel",
                "scored_intersect_batched": "scored_intersect_kernel"}


def _sha(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def measure(kernel, args, ops, ref, si, timing, flush, reps: int,
            **info) -> dict:
    """Check one call twice against the plain version and time it;
    returns its line."""
    fn, plain = getattr(ops, kernel), getattr(ref, kernel + "_ref")
    got, again = fn(*args), fn(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    equal = torch.equal(got, want) and torch.equal(again, want)

    def call():
        return fn(*args)
    dev_ms, seen = timing.profiled_ms(call, KERNEL_NAMES[kernel], reps=reps)
    if kernel == "scored_intersect_batched":
        a, b, rest, th = args
        nbytes = scored_bytes(si, a, b, th, rest)
    elif kernel == "segment_intersect_mask":
        nbytes = single_bytes(si, *args)
    else:
        nbytes = batched_bytes(si, *args)
    return dict(kernel=kernel, **info,
                ms=timing.cuda_ms(call, reps=reps),
                ms_cold=timing.cuda_ms_cold(call, flush, reps=reps),
                device_ms=dev_ms, kernels_seen=seen, bytes=nbytes,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                hits=int((got > 0).sum()), bit_equal=equal,
                sha256=_sha(got))


def _row(si, s, r: int):
    """Row ``r`` of a stack (StackedLists or ScoredStack) alone, at the
    same block count and payload width."""
    if hasattr(s, "ids"):
        return si.ScoredStack(ids=_row(si, s.ids, r),
                              swords=s.swords[r: r + 1].contiguous(),
                              bmax=s.bmax[r: r + 1].contiguous())
    return si.StackedLists(*[getattr(s, f)[r: r + 1].contiguous()
                             for f in si.StackedLists._fields])


def _all_pad(si, s):
    """The stack with every ``ns`` 0: the call's pad-only part."""
    if hasattr(s, "ids"):
        return s._replace(ids=_all_pad(si, s.ids))
    return s._replace(ns=torch.zeros_like(s.ns))


def phase2_lines(ops, ref, si, timing, flush, reps: int):
    sa, sb, a1, b1, sca, scb, rest, ths = phase2_inputs(si)
    rows = sa.firsts.shape[0]
    shape = f"N={rows} rows, NB={sa.n_blocks}, PW={sa.n_words}"
    yield measure("segment_intersect_mask_batched", (sa, sb), ops, ref, si,
                  timing, flush, reps, shape="batched " + shape)
    yield measure("segment_intersect_mask", (a1, b1), ops, ref, si, timing,
                  flush, reps,
                  shape=f"single pair: a {a1.n} docids in {a1.n_blocks} "
                        f"blocks, b {b1.n} in {b1.n_blocks}")
    for name, th in ths.items():
        yield measure("scored_intersect_batched", (sca, scb, rest, th), ops,
                      ref, si, timing, flush, reps,
                      shape=f"scored th {name} " + shape)
    for r in range(rows):
        yield measure("segment_intersect_mask_batched",
                      (_row(si, sa, r), _row(si, sb, r)), ops, ref, si,
                      timing, flush, reps,
                      shape=f"batched row {r} alone (a {DENS_A[r]}, b "
                            f"{DENS_B[r]}: {int(sa.ns[r])} vs "
                            f"{int(sb.ns[r])} docids)")
    for r in range(rows):
        yield measure("scored_intersect_batched",
                      (_row(si, sca, r), _row(si, scb, r), rest[r: r + 1],
                       ths["none"][r: r + 1]), ops, ref, si, timing, flush,
                      reps, shape=f"scored th none row {r} alone")
    yield measure("segment_intersect_mask_batched",
                  (_all_pad(si, sa), sb), ops, ref, si, timing, flush, reps,
                  shape="batched all-pad " + shape)
    yield measure("scored_intersect_batched",
                  (_all_pad(si, sca), scb, rest, ths["none"]), ops, ref, si,
                  timing, flush, reps, shape="scored all-pad " + shape)


def replay_lines(path: Path, ops, ref, si, timing, flush, reps: int):
    saved = torch.load(path, weights_only=False)
    for kernel in ("segment_intersect_mask_batched",
                   "scored_intersect_batched", "segment_intersect_mask"):
        for i, host in enumerate(saved.get(kernel, [])):
            args = tuple(from_host(si, x) for x in host)
            lead = args[0].ids if kernel == "scored_intersect_batched" \
                else args[0]
            if kernel == "segment_intersect_mask":
                shape = (f"a {lead.n} docids in {lead.n_blocks} blocks, b "
                         f"{args[1].n} in {args[1].n_blocks}")
            else:
                shape = (f"N={lead.firsts.shape[0]} rows, "
                         f"NB={lead.firsts.shape[1]}, "
                         f"PW={lead.payload.shape[1]}")
            yield measure(kernel, args, ops, ref, si, timing, flush, reps,
                          shape=f"saved call {i}: {shape}", call=i)
            del args
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE.parents[3],
                    help="root of the checkout whose kernels are timed")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--calls", type=Path, default=None,
                    help="the path's saved calls (chip_smoke.py "
                         "--segment-calls)")
    args = ap.parse_args(argv)
    timing = _timing()
    sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import segment_intersect as si
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": str(args.root), "card": card,
                      "package": ops.__file__}), flush=True)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    ok = True
    lines = phase2_lines(ops, ref, si, timing, flush, args.reps)
    if args.calls is not None:
        lines = itertools.chain(lines, replay_lines(
            args.calls, ops, ref, si, timing, flush, args.reps))
    for line in lines:
        ok &= line["bit_equal"]
        print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
