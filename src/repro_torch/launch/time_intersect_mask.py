"""Time one checkout's ``intersect_mask`` kernel with this checkout's
timers, so two checkouts timed in one call share one yardstick.

    python src/repro_torch/launch/time_intersect_mask.py [--root DIR]

``DIR`` (this checkout by default) is the root of the checkout whose
``src/repro_torch`` is imported and whose kernels are built, into its own
``_build``; the timers always come from this file's checkout
(``kernels/timing.py``, loaded by path).  To compare a parent commit with
a change, unpack the parent into a directory that ``.gitignore`` lists
and run parent, change, change, parent in one job on one card.

Shapes (``chip_smoke.py`` phase 2's): a head term's docids (density 0.55
over a 2**23-tweet segment, about 4.61M) and a torso term's (0.02, about
168k), each padded with INVALID to the engine's ``max_len = 2**23``: a =
head against b = torso, the swapped pair, and the head against an
all-pad b.  For each it prints one JSON line: the kernel warm (``ms``),
each launch alone after the L2 is overwritten (``ms_cold``) and by the
profiler (``device_ms``); the library call (``searchsorted`` + ``gather``)
warm and flushed; the bound as the call needs it (``bytes``: a's valid
prefix, b's entries inside a's value range, the int32 mask over all of
a) and over the whole padded arrays (``bytes_full``); and whether two
calls equal the checkout's plain version bit for bit.  It exits 1 if
any shape disagrees.

``--calls FILE`` adds the calls one route really made: the
``(a, b)`` pairs that ``chip_smoke.py --intersect-calls FILE`` saves
from phase 4's sequential route (2**16-tweet segments), replayed in
order.  Their line gives the same timers and bounds summed over the
sequence (``REPLAY_REPS`` sequences a timer: more would overrun the
stream's queue of pending launches while the device sleeps) and
``calls``, the sequence's length.

This module also holds the inputs every check of the kernel uses
(:func:`edge_cases`, :func:`full_width_shapes`) and the byte count of
the bound (:func:`bound_bytes`); it imports nothing but torch and numpy
at its top.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve()
INVALID = 0xFFFFFFFF
MAX_LEN = 1 << 23                 # the engine's max_len at a 2**23 segment
HBM_BYTES_PER_S = 3.35e12
DENSITIES = (0.55, 0.02)          # phase 2's head a-list and torso b-list
REPLAY_REPS = 4                   # sequences of saved calls per timer


def _timing():
    spec = importlib.util.spec_from_file_location(
        "_kernel_timing", HERE.parent.parent / "kernels" / "timing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pad(rows, n: int) -> np.ndarray:
    """Ascending rows -> int64 [len(rows), n], padded with INVALID."""
    out = np.full((len(rows), n), INVALID, np.int64)
    for r, x in enumerate(rows):
        out[r, : len(x)] = np.sort(np.asarray(x, np.int64))
    return out


def edge_cases(tile: int, seed: int = 0):
    """``(name, a, b)`` int64 [rows, n] pairs of ascending INVALID-padded
    lists, sized from ``tile`` so that duplicated runs (1, tile - 1,
    tile, tile + 1 and 2 tile + 3 copies) straddle the kernel's merge
    diagonals: runs in a, in b and in both; empty valid prefixes of a,
    of b and of both; a == b; disjoint ranges either way; values 0 and
    0xFFFFFFFE; na != nb either way; several rows; no pads at all; one
    lane; and a b that reaches far past both ends of a."""
    rng = np.random.default_rng(seed)
    t = tile
    n = 3 * t + 5

    def uniq(k, hi, lo=0):
        return np.unique(rng.integers(lo, hi, max(k, 1)))

    def dup(k, hi):
        return np.sort(rng.integers(0, hi, max(k, 1)))
    v = np.arange(10, 52, 7)
    runs = np.repeat(v, [1, t - 1, t, t + 1, 2 * t + 3, 2])
    runs_b = np.repeat(v[1:], [2 * t + 3, t + 1, t, t - 1, 1])
    top = 0xFFFFFFFE
    ext_a = np.concatenate([[0, 0], uniq(t, top, 1), [top]])
    ext_b = np.concatenate([[0], uniq(t, top, 1), [top, top]])
    x = uniq(n, 10 * n)
    w = runs.size + 3
    return [
        ("dup_runs_a", _pad([runs], w), _pad([np.union1d(v[::2],
                                                         uniq(t, 60))], n)),
        ("dup_runs_b", _pad([np.union1d(v, uniq(t, 60))], n),
         _pad([runs], w)),
        ("dup_runs_both", _pad([runs], w), _pad([runs_b], w)),
        ("dup_random", _pad([dup(n, n // 3 + 2)], n + 2),
         _pad([dup(n // 2, n // 3 + 2)], n)),
        ("empty_a", _pad([[]], n), _pad([uniq(n, 4 * n)], n)),
        ("empty_b", _pad([uniq(n, 4 * n)], n), _pad([[]], n)),
        ("empty_both", _pad([[]], n), _pad([[]], n + 1)),
        ("a_eq_b", _pad([x], n + 1), _pad([x], n + 1)),
        ("a_below_b", _pad([uniq(n, 1000)], n),
         _pad([1000 + uniq(n, 1000)], n)),
        ("a_above_b", _pad([1000 + uniq(n, 1000)], n),
         _pad([uniq(n, 1000)], n)),
        ("extremes", _pad([ext_a], ext_a.size + 2), _pad([ext_b], ext_b.size)),
        ("na_lt_nb", _pad([uniq(t // 2 + 1, 5 * t)], t // 2 + 3),
         _pad([uniq(4 * t, 5 * t)], 4 * t + 7)),
        ("na_gt_nb", _pad([uniq(4 * t, 5 * t)], 4 * t + 7),
         _pad([uniq(t // 2 + 1, 5 * t)], t // 2 + 3)),
        ("rows", _pad([runs[: n], [], uniq(n, 3 * n), dup(n, n)], n),
         _pad([uniq(n, 3 * n), uniq(n, 60), [], dup(n // 2, n)], n)),
        ("no_pads", _pad([np.arange(n) * 3], n), _pad([np.arange(n) * 2], n)),
        ("one_lane_hit", _pad([[7]], 1), _pad([[7]], 1)),
        ("one_lane_pad", _pad([[]], 1), _pad([[7]], 1)),
        ("b_past_both_ends", _pad([5000 + uniq(t, 3000)], t + 4),
         _pad([uniq(8 * t, 20000)], 8 * t)),
    ]


def segment_lists(seed: int = 0, n_docs: int = MAX_LEN,
                  densities=DENSITIES):
    """Ascending docid sets of the given densities over one segment."""
    rng = np.random.default_rng(seed)
    return [np.nonzero(rng.random(n_docs) < p)[0].astype(np.int64)
            for p in densities]


def full_width_shapes(head, torso, max_len: int = MAX_LEN, device="cuda"):
    """``(name, a, b)`` at the engine's width: head vs torso, the swapped
    pair, and the head against an all-pad b."""
    def padded(x):
        out = torch.full((max_len,), INVALID, dtype=torch.int64,
                         device=device)
        out[: len(x)] = torch.as_tensor(np.asarray(x, np.int64),
                                        device=device)
        return out
    h, s = padded(head), padded(torso)
    return [("head vs torso", h, s), ("torso vs head", s, h),
            ("head vs all-pad", h, torch.full_like(h, INVALID))]


def bound_bytes(a, b):
    """``(needed, full)`` bytes of one call: per row, when a has a valid
    prefix and b has entries inside ``[a[0], a[na_v - 1]]``, those
    entries and the prefix (8 bytes each), plus the int32 mask over all
    of a; and the same over the whole padded arrays."""
    na, nb = a.shape[-1], b.shape[-1]
    a2, b2 = a.reshape(-1, na).contiguous(), b.reshape(-1, nb).contiguous()
    inv = torch.full((a2.shape[0], 1), INVALID, dtype=a2.dtype,
                     device=a2.device)
    na_v = torch.searchsorted(a2, inv)[:, 0]
    last = torch.gather(a2, 1, (na_v - 1).clamp(min=0)[:, None])
    jlo = torch.searchsorted(b2, a2[:, :1].contiguous())[:, 0]
    jhi = torch.searchsorted(b2, last, right=True)[:, 0]
    nb_r = torch.where(na_v > 0, jhi - jlo, 0)
    live = nb_r > 0
    needed = 8 * int(((na_v + nb_r) * live).sum()) + 4 * a2.numel()
    return needed, 8 * (a2.numel() + b2.numel()) + 4 * a2.numel()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE.parents[3],
                    help="root of the checkout whose kernel is timed")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--calls", type=Path, default=None,
                    help="saved (a, b) inputs to replay in order "
                         "(chip_smoke.py --intersect-calls)")
    args = ap.parse_args(argv)
    timing = _timing()
    sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.kernels import ops, ref
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
    for name, a, b in full_width_shapes(*segment_lists()):
        want = ref.intersect_mask_ref(a, b)
        got, again = ops.intersect_mask(a, b), ops.intersect_mask(a, b)
        torch.cuda.synchronize()
        equal = torch.equal(got, want) and torch.equal(again, want)
        ok &= equal

        def call(a=a, b=b):
            return ops.intersect_mask(a, b)

        def library(a=a, b=b):
            pos = torch.searchsorted(b, a).clamp_(max=b.shape[-1] - 1)
            return torch.gather(b, -1, pos) == a
        dev_ms, seen = timing.profiled_ms(call, "intersect_mask",
                                          reps=args.reps)
        needed, full = bound_bytes(a, b)
        print(json.dumps(dict(
            shape=name, valid=[int((a != INVALID).sum()),
                               int((b != INVALID).sum())],
            ms=timing.cuda_ms(call, reps=args.reps),
            ms_cold=timing.cuda_ms_cold(call, flush, reps=args.reps),
            device_ms=dev_ms, kernels_seen=seen,
            library_ms=timing.cuda_ms(library, reps=args.reps),
            library_ms_cold=timing.cuda_ms_cold(library, flush,
                                                reps=args.reps),
            bytes=needed, bound_ms=needed / HBM_BYTES_PER_S * 1e3,
            bytes_full=full, bound_full_ms=full / HBM_BYTES_PER_S * 1e3,
            hits=int(got.sum()), bit_equal=equal)), flush=True)
    if args.calls is not None:
        ok &= replay(args.calls, ops, ref, timing, flush)
    return 0 if ok else 1


def replay(path: Path, ops, ref, timing, flush) -> bool:
    """Time the saved calls as one sequence; print their line (the
    profiler's ``kernels_seen`` is ``REPLAY_REPS`` x ``calls`` unless a
    session dropped events) and return whether every call equals the
    plain version, twice."""
    calls = [(a.cuda(), b.cuda()) for a, b in torch.load(path)]
    equal = all(torch.equal(ops.intersect_mask(a, b), w) and
                torch.equal(ops.intersect_mask(a, b), w)
                for a, b, w in ((a, b, ref.intersect_mask_ref(a, b))
                                for a, b in calls))

    def seq():
        for a, b in calls:
            ops.intersect_mask(a, b)

    def library():
        for a, b in calls:
            pos = torch.searchsorted(b, a).clamp_(max=b.shape[-1] - 1)
            torch.gather(b, -1, pos) == a
    reps = REPLAY_REPS
    dev_ms, seen = timing.profiled_total_ms(seq, "intersect_mask", reps=reps)
    needed = sum(bound_bytes(a, b)[0] for a, b in calls)
    full = sum(bound_bytes(a, b)[1] for a, b in calls)
    print(json.dumps(dict(
        shape=f"saved calls ({path.name})", calls=len(calls),
        na=sorted({a.shape[-1] for a, _ in calls}),
        ms=timing.cuda_ms(seq, reps=reps),
        ms_cold=timing.cuda_ms_cold(seq, flush, reps=reps),
        device_ms=dev_ms, kernels_seen=seen,
        library_ms=timing.cuda_ms(library, reps=reps),
        library_ms_cold=timing.cuda_ms_cold(library, flush, reps=reps),
        bytes=needed, bound_ms=needed / HBM_BYTES_PER_S * 1e3,
        bytes_full=full, bound_full_ms=full / HBM_BYTES_PER_S * 1e3,
        bit_equal=equal)), flush=True)
    return equal


if __name__ == "__main__":
    sys.exit(main())
