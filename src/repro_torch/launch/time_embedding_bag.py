"""Time one checkout's ``embedding_bag`` kernel at the recsys path's own
calls with this checkout's timers, so two checkouts timed in one call
share one yardstick.

    python3 chip_smoke.py --bag-calls FILE       # save the path's calls
    python src/repro_torch/launch/time_embedding_bag.py --root DIR \
        --calls FILE

``FILE`` holds the ten ``embedding_bag`` calls that one entry-point call
of each of ``chip_smoke.py`` phase 6's cells makes (DCN-v2 serve_p99,
serve_bulk and retrieval_cand, xDeepFM, DIEN and DLRM-MLPerf at
serve_p99): each call's ``indices``, ``offsets``, mode, the table's shape
and dtype, and its launches per run of the phase.  The tables are not
saved (DLRM-MLPerf's alone is 44.77 GiB): this script makes one table at
a time from a seeded generator on the card, at the saved shape and
dtype, the same for every checkout.

``DIR`` (this checkout by default) is the root of the checkout whose
``src/repro_torch`` is imported and whose kernels are built, into its own
``_build``; the timers always come from this file's checkout
(``kernels/timing.py``, loaded by path).  To compare a parent commit with
a change, unpack the parent into a directory that ``.gitignore`` lists
and run parent, change, change, parent in one job on one card.

For each call it prints one JSON line: the kernel warm (``ms``), each
launch alone after the L2 is overwritten (``ms_cold``) and by the
profiler (``device_ms``); ``F.embedding_bag`` flushed (``library_ms``,
timed only); the bound (``bytes``: each distinct clipped row once, the
indices, the offsets and the fp32 output, over 3.35 TB/s) and the bytes
counting every looked-up row (``bytes_every_row``); whether two calls
agree bit for bit with each other, with the checkout's plain version on
single-row bags and with :func:`in_order_bags` on every bag; and the
SHA-256 of the output's bytes, which two checkouts' lines share when
their outputs are bit-identical.  It exits 1 if any check fails.

This module also holds what every check of the kernel uses: the
kernel's summation order in plain torch (:func:`in_order_bags`), the
synthetic cases (:func:`edge_cases`, :func:`path_shapes`) and the byte
count of the bound (:func:`bound_bytes`).  It imports nothing but torch
and numpy at its top.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve()
HBM_BYTES_PER_S = 3.35e12
TABLE_SEED = 17                 # the replayed tables' generator seed

# The ten calls one entry-point call of each phase-6 cell makes, in the
# order ``chip_smoke.py`` captures them: (cell, site in the models).
PATH_SITES = (
    ("dcn-v2/serve_p99", "lookup (recsys.py embedding_lookup)"),
    ("dcn-v2/serve_bulk", "lookup (recsys.py embedding_lookup)"),
    ("dcn-v2/retrieval_cand", "user bag (steps.py retrieval_step)"),
    ("dcn-v2/retrieval_cand", "candidates (recsys.py retrieval_scores)"),
    ("xdeepfm/serve_p99", "lookup (recsys.py embedding_lookup)"),
    ("xdeepfm/serve_p99", "linear term (recsys.py xdeepfm_forward)"),
    ("dien/serve_p99", "target lookup (recsys.py dien_forward)"),
    ("dien/serve_p99", "history lookup (recsys.py dien_forward)"),
    ("dien/serve_p99", "history mean (recsys.py dien_forward)"),
    ("dlrm-mlperf/serve_p99", "lookup (recsys.py embedding_lookup)"),
)
# The same calls' shapes: (bags, rows per bag, D, table dtype, mode).
PATH_SHAPES = (
    (13_312, 1, 16, torch.float32, "sum"),
    (6_815_744, 1, 16, torch.float32, "sum"),
    (1, 26, 16, torch.float32, "mean"),
    (1_000_000, 1, 16, torch.float32, "sum"),
    (19_968, 1, 10, torch.float32, "sum"),
    (512, 39, 1, torch.float32, "sum"),
    (1_024, 1, 18, torch.float32, "sum"),
    (102_400, 1, 18, torch.float32, "sum"),
    (1_024, 100, 18, torch.float32, "mean"),
    (13_312, 1, 128, torch.bfloat16, "sum"),
)


def _timing():
    spec = importlib.util.spec_from_file_location(
        "_kernel_timing", HERE.parent.parent / "kernels" / "timing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bag_bounds(offsets, n: int):
    """``(lo, hi)`` int64 [B] of each bag as the kernel clamps them:
    ``lo = clip(offsets[b], 0, n)``, ``hi = max(lo, min(offsets[b+1],
    n))``."""
    raw = offsets.long()
    lo = raw[:-1].clamp(0, n)
    return lo, torch.maximum(lo, raw[1:].clamp(max=n))


def in_order_bags(table, indices, offsets, mode: str = "sum", *,
                  row_lo: int = 0, row_hi=None, num_rows=None):
    """The kernel's contract in its own summation order: each column of
    bag b starts from the bag's first row and adds the others one at a
    time in bag order, in fp32; the mean divides by ``max(count, 1)``;
    ids clip into ``[0, R-1]`` and offsets clamp as :func:`bag_bounds`.
    -> fp32 [B, D], bit-identical to the CUDA kernel (the plain version
    ``ref.embedding_bag_ref`` sums in another order).  With a row window
    ``table`` holds rows ``[row_lo, row_hi)`` of a ``num_rows``-row
    table (by default the whole table), and a clipped id outside the
    window is a zero row in its place in the order, as in the kernel."""
    n_local, D = table.shape
    lo_w = int(row_lo)
    hi_w = lo_w + n_local if row_hi is None else int(row_hi)
    R = hi_w if num_rows is None else int(num_rows)
    B = offsets.shape[0] - 1
    n = indices.shape[0]
    out = torch.zeros((B, D), dtype=torch.float32, device=table.device)
    lo, hi = bag_bounds(offsets, n)
    lens = hi - lo
    longest = int(lens.max()) if B else 0
    ids = indices.long().clamp(0, R - 1)
    inside = (ids >= lo_w) & (ids < hi_w)
    ids = torch.where(inside, ids - lo_w, 0)
    for r in range(longest):
        b = torch.nonzero(lens > r)[:, 0]
        at = lo[b] + r
        x = torch.where(inside[at, None], table[ids[at]].float(), 0.0)
        out[b] = x if r == 0 else out[b] + x
    if mode == "mean":
        out = out / lens.clamp(min=1).float()[:, None]
    return out


def bound_bytes(R: int, D: int, esize: int, indices, offsets):
    """``(needed, every_row)`` bytes of one call: each distinct clipped
    row once (``every_row``: every looked-up row), plus the int32
    indices and offsets and the fp32 output."""
    rows = torch.unique(indices.long().clamp(0, R - 1)).numel()
    B = offsets.numel() - 1
    rest = indices.numel() * 4 + offsets.numel() * 4 + B * D * 4
    return rows * D * esize + rest, indices.numel() * D * esize + rest


def _csr(lens, start: int = 0) -> np.ndarray:
    off = np.zeros(len(lens) + 1, np.int64)
    off[1:] = np.cumsum(lens)
    return (off + start).astype(np.int32)


def path_shapes(R: int = 100_000, seed: int = 0, device="cuda"):
    """``(name, table, indices, offsets, mode)`` at the ten path calls'
    bag counts, lengths, widths and dtypes, over an ``R``-row table."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for (B, L, D, dt, mode), (cell, site) in zip(PATH_SHAPES, PATH_SITES):
        table = torch.randn(R, D, generator=gen, device=device).to(dt)
        idx = torch.as_tensor(rng.integers(0, R, B * L, dtype=np.int32),
                              device=device)
        off = torch.arange(0, B * L + 1, L, dtype=torch.int32, device=device)
        out.append((f"path {cell} {site.split(' (')[0]}", table, idx, off,
                    mode))
    return out


def edge_cases(R: int = 100_000, seed: int = 0, device="cuda"):
    """``(name, table, indices, offsets, mode)`` cases of the CSR the
    kernel must take, each in sum and mean, at D in {1, 10, 16, 18, 128}
    with fp32 and bf16 tables: bags far longer than one chunk of the
    launch plan and bags that straddle its tiles (lengths up to 2,500
    among runs of single rows); ``offsets[0] > 0`` with positions past
    ``offsets[B]`` unused; a malformed CSR (decreasing, negative and
    past-the-end offsets, which clamp); ids out of range (clipped); and
    table views that start at an odd row and at an odd element, so the
    base address is not 16-byte (or even 4-byte) aligned."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    cases = []

    def ids(n):
        return torch.as_tensor(rng.integers(-50, R + 50, n, dtype=np.int64)
                               .astype(np.int32), device=device)

    def dev(a):
        return torch.as_tensor(a, device=device)
    long_lens = np.r_[0, 1, 700, 3, 2500, 1, 0, 129, 513, 64,
                      rng.integers(0, 300, 200)]
    ones = np.ones(3000, np.int64)
    ones[::97] = rng.integers(2, 900, ones[::97].size)
    for D in (1, 10, 16, 18, 128):
        for dt in (torch.float32, torch.bfloat16):
            base = torch.randn(R + 2, D, generator=gen, device=device).to(dt)
            table = base[:R]
            tag = f"D={D} {str(dt)[6:]}"
            off = _csr(long_lens)
            cases.append((f"long bags {tag}", table, ids(off[-1]), dev(off)))
            off = _csr(ones)
            cases.append((f"long bags among single rows {tag}", table,
                          ids(off[-1]), dev(off)))
            off = _csr(rng.integers(0, 40, 500), start=37)
            cases.append((f"offsets[0] > 0 {tag}", table,
                          ids(off[-1] + 61), dev(off)))
            n = 4000
            bad = rng.integers(-300, n + 300, 801).astype(np.int32)
            bad[::7] = np.sort(bad[::7])[::-1]        # runs that decrease
            cases.append((f"malformed offsets {tag}", table, ids(n),
                          dev(bad)))
            if D in (10, 16, 18, 128):
                flat = base.reshape(-1)
                views = (("odd row", base[1:R + 1]),
                         ("odd element", flat[1:1 + R * D].view(R, D)))
                for what, view in views:
                    for lens in (np.ones(5000, np.int64),
                                 rng.integers(0, 70, 700)):
                        off = _csr(lens)
                        cases.append((f"table view at an {what} "
                                      f"(address mod 16 = "
                                      f"{view.data_ptr() % 16}) {tag} "
                                      f"max len {lens.max()}", view,
                                      ids(off[-1]), dev(off)))
    return [(name, t, i, o, mode) for name, t, i, o in cases
            for mode in ("sum", "mean")]


def load_calls(path: Path):
    """The calls ``chip_smoke.py --bag-calls`` saved (see
    :func:`save_calls`): a list of dicts with ``cell``, ``site``,
    ``table_shape``, ``table_dtype``, ``mode``, ``launches``,
    ``indices`` and ``offsets`` (int32 CPU tensors)."""
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        for i, m in enumerate(meta):
            m["indices"] = torch.from_numpy(z[f"indices_{i}"])
            m["offsets"] = torch.from_numpy(z[f"offsets_{i}"])
    return meta


def save_calls(path, calls) -> int:
    """Write ``calls`` (dicts as :func:`load_calls` returns them, tensors
    on any device) to ``path`` (compressed npz); returns its size."""
    arrays, meta = {}, []
    for i, c in enumerate(calls):
        arrays[f"indices_{i}"] = c["indices"].cpu().numpy()
        arrays[f"offsets_{i}"] = c["offsets"].cpu().numpy()
        meta.append({k: v for k, v in c.items()
                     if k not in ("indices", "offsets")})
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        np.savez_compressed(f, meta=np.array(json.dumps(meta)), **arrays)
    return Path(path).stat().st_size


def _table(shape, dtype: str):
    gen = torch.Generator(device="cuda").manual_seed(TABLE_SEED)
    return torch.randn(*shape, generator=gen, device="cuda",
                       dtype=getattr(torch, dtype))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE.parents[3],
                    help="root of the checkout whose kernel is timed")
    ap.add_argument("--calls", type=Path, required=True,
                    help="the path's saved calls (chip_smoke.py "
                         "--bag-calls)")
    ap.add_argument("--reps", type=int, default=10)
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
    calls = load_calls(args.calls)
    ok, table, key = True, None, None
    for c in calls:
        if key != (tuple(c["table_shape"]), c["table_dtype"]):
            table = None
            torch.cuda.empty_cache()
            key = (tuple(c["table_shape"]), c["table_dtype"])
            table = _table(*key)
        ok &= replay_one(c, table, ops, ref, timing, flush, args.reps)
    return 0 if ok else 1


def replay_one(c, table, ops, ref, timing, flush, reps: int) -> bool:
    """Check and time one saved call; print its line; return whether
    every check held."""
    idx, off, mode = c["indices"].cuda(), c["offsets"].cuda(), c["mode"]
    R, D = table.shape
    got = ops.embedding_bag(table, idx, off, mode)
    again = ops.embedding_bag(table, idx, off, mode)
    want = ref.embedding_bag_ref(table, idx, off, mode)
    order = in_order_bags(table, idx, off, mode)
    torch.cuda.synchronize()
    lo, hi = bag_bounds(off, idx.numel())
    one = (hi - lo) == 1
    checks = dict(repeat_equal=torch.equal(got, again),
                  single_rows_equal_plain=torch.equal(got[one], want[one]),
                  equal_in_order=torch.equal(got, order))

    def call():
        return ops.embedding_bag(table, idx, off, mode)
    lib_idx = idx.clamp(0, R - 1)

    def library():
        return torch.nn.functional.embedding_bag(
            lib_idx, table, off, mode=mode, include_last_offset=True)
    dev_ms, seen = timing.profiled_ms(call, "embedding_bag", reps=reps)
    needed, every = bound_bytes(R, D, table.element_size(), idx, off)
    lens = (hi - lo).float()
    print(json.dumps(dict(
        cell=c["cell"], site=c["site"], bags=off.numel() - 1,
        ids=idx.numel(), mean_len=float(lens.mean()) if lens.numel() else 0,
        table=[R, D, c["table_dtype"]], mode=mode, launches=c["launches"],
        ms=timing.cuda_ms(call, reps=reps),
        ms_cold=timing.cuda_ms_cold(call, flush, reps=reps),
        device_ms=dev_ms, kernels_seen=seen,
        library_ms=timing.cuda_ms_cold(library, flush, reps=reps),
        bytes=needed, bound_ms=needed / HBM_BYTES_PER_S * 1e3,
        bytes_every_row=every,
        bound_every_row_ms=every / HBM_BYTES_PER_S * 1e3,
        sha256=hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest(),
        **checks)), flush=True)
    return all(checks.values())


if __name__ == "__main__":
    sys.exit(main())
