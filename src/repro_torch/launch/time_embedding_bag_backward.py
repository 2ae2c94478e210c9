"""Time one checkout's ``embedding_bag_backward`` kernel at the training
path's calls with this checkout's timers, so two checkouts timed in one
call share one yardstick.

    python src/repro_torch/launch/time_embedding_bag_backward.py --root DIR

The calls are rebuilt here from ``chip_smoke.py``'s seeds, the same for
every checkout: phase 10's five :func:`bwd_cases` (DCN-v2 at
train_batch, Zipf ids, mean bags with empty ones and positions outside
every bag, a bf16 table of pooled bags, and one row of 110,000
contributions) and phase 6r's windowed DCN-v2 call (:func:`rank_windows`:
the last step's ids at B 16,384, each of the four ranks' row windows,
with a seeded gradient in place of the model's).

``DIR`` (this checkout by default) is the root of the checkout whose
``src/repro_torch`` is imported and whose kernels are built, into its own
``_build``; the timers always come from this file's checkout
(``kernels/timing.py``, loaded by path).  To compare a parent commit with
a change, unpack the parent into a directory that ``.gitignore`` lists
and run parent, change, change, parent in one job on one card.

For each call it prints one JSON line: the wrapper (the plan's sort and
the kernels) warm (``ms``), each call alone after the L2 is overwritten
(``ms_cold``) and by the profiler (``device_ms``, with ``parts``: each
device kernel's ms per call by name); the bound (``bytes``: the dense
output written once, grad_out, the indices and the offsets read once,
over 3.35 TB/s); whether two calls agree bit for bit and whether the
output is bit-equal to :func:`in_order_backward`; and the SHA-256 of the
output's bytes, which two checkouts' lines share when their outputs are
bit-identical.  It exits 1 if any check fails.

This module also holds the kernel's summation order in plain torch
(:func:`in_order_backward`), which every check of the kernel uses, and
the calls ``chip_smoke.py`` checks it at (:func:`bwd_cases`,
:func:`width_cases`, :func:`rank_windows`).  It imports nothing but
torch and numpy at its top.
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
CHUNK = 32                 # sorted entries a chunk (the kernel's kChunk)
HOT_ROW = 777              # bwd_cases' hot row and its contributions
HOT_COUNT = 110_000
RANK_B, RANK_STEP, RANKS = 16_384, 1, 4   # phase 6r's last DCN-v2 step


def _timing():
    spec = importlib.util.spec_from_file_location(
        "_kernel_timing", HERE.parent.parent / "kernels" / "timing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def in_order_backward(grad_out, indices, offsets, mode: str, num_rows: int,
                      dtype, *, row_lo: int = 0, row_hi=None):
    """The backward kernel's contract in its own summation order, step by
    step: the in-bag positions whose clipped row (into ``[0, num_rows -
    1]``) lies in the window ``[row_lo, row_hi)`` (the whole table by
    default), in (row, position) order, are cut into chunks of ``CHUNK``
    entries of the whole table's sort (a window's entries start after the
    in-bag positions whose row lies below it); each row sums its entries
    inside a chunk in position order from 0.0 (each contribution
    ``grad_out[b]``, divided by max(len_b, 1) in mean mode), then
    left-folds those pieces in chunk order from the first; the fp32 sum
    is cast once to ``dtype``.  -> ``[row_hi - row_lo, D]``, untouched
    rows zero; bit-identical to the CUDA kernel (the plain version
    ``ref.embedding_bag_backward_ref`` sums each row in position order in
    one run)."""
    R = int(num_rows)
    lo = int(row_lo)
    hi = R if row_hi is None else int(row_hi)
    D = grad_out.shape[1]
    dev = grad_out.device
    n = indices.shape[0]
    pos = torch.arange(n, device=dev)
    ends = offsets[1:].long()
    inside = (pos >= offsets[0].long()) & (pos < offsets[-1].long())
    rows = indices.long().clamp(0, R - 1)
    below = int((inside & (rows < lo)).sum())
    p = torch.nonzero(inside & (rows >= lo) & (rows < hi))[:, 0]
    r = rows[p] - lo
    order = torch.sort(r, stable=True).indices
    p, r = p[order], r[order]
    out = torch.zeros((hi - lo, D), dtype=torch.float32, device=dev)
    if p.numel() == 0:
        return out.to(dtype)
    bag = torch.searchsorted(ends, p, right=True)
    x = grad_out[bag].float()
    if mode == "mean":
        cnt = (ends - offsets[:-1].long()).clamp(min=1)
        x = x / cnt[bag].float()[:, None]
    chunk = (torch.arange(p.numel(), device=dev) + below) // CHUNK
    # pieces: (row, chunk) groups, each summed in order from 0.0
    new = torch.ones(p.numel(), dtype=torch.bool, device=dev)
    new[1:] = (r[1:] != r[:-1]) | (chunk[1:] != chunk[:-1])
    gid = torch.cumsum(new, 0) - 1
    start = torch.nonzero(new)[:, 0]
    at = torch.arange(p.numel(), device=dev) - start[gid]
    piece = torch.zeros((start.numel(), D), dtype=torch.float32, device=dev)
    for i in range(int(at.max()) + 1):
        sel = torch.nonzero(at == i)[:, 0]
        piece[gid[sel]] = piece[gid[sel]] + x[sel]
    # each row's pieces, left-folded in chunk order from the first
    prow = r[start]
    first = torch.ones(start.numel(), dtype=torch.bool, device=dev)
    first[1:] = prow[1:] != prow[:-1]
    rid = torch.cumsum(first, 0) - 1
    k = torch.arange(start.numel(), device=dev) - \
        torch.nonzero(first)[:, 0][rid]
    acc = piece[first].clone()
    by_k = torch.sort(k, stable=True).indices
    counts = torch.bincount(k).tolist()
    s = counts[0]
    for c in counts[1:]:
        sel = by_k[s:s + c]
        acc[rid[sel]] = acc[rid[sel]] + piece[sel]
        s += c
    out[prow[first]] = acc
    return out.to(dtype)


def bound_bytes(rows: int, dtype, grad_out, indices, offsets) -> int:
    """The dense output written once and every input read once."""
    esize = torch.empty((), dtype=dtype).element_size()
    return rows * grad_out.shape[1] * esize + 4 * (
        grad_out.numel() + indices.numel() + offsets.numel())


def _dcn():
    """DCN-v2's config, padded table rows, train_batch B and field
    offsets (the imported checkout's registry)."""
    from repro_torch.configs import registry
    from repro_torch.models import recsys
    cfg = registry.get("dcn-v2").config
    foff = np.zeros(cfg.n_sparse, np.int64)
    foff[1:] = np.cumsum(cfg.vocab_sizes)[:-1]
    return (cfg, recsys.padded_rows(cfg.total_rows),
            registry.get_shape("dcn-v2", "train_batch").global_batch, foff)


def bwd_case(seed: int, name: str, R: int, D: int, dtype, lens, ids,
             mode: str, lo: int = 0, hi: int = 0, device="cuda"):
    """(name, grad_out, indices, offsets, mode, R, dtype); ``ids(n)``
    draws the n indices; ``lo`` positions before the first bag and
    ``hi`` after the last."""
    off = np.zeros(len(lens) + 1, np.int64)
    off[1:] = np.cumsum(lens)
    off += lo
    n = int(off[-1]) + hi
    g = torch.randn(len(lens), D, device=device,
                    generator=torch.Generator(device).manual_seed(seed))
    return (name, g, torch.as_tensor(ids(n), dtype=torch.int32,
                                     device=device),
            torch.as_tensor(off, dtype=torch.int32, device=device), mode, R,
            dtype)


def bwd_cases(seed: int, device="cuda") -> list:
    """DCN-v2 at train_batch (65,536 x 26 single-row bags into the
    33,762,816 x 16 fp32 table, uniform ids per field: the path's call),
    the same bags over a duplicate-heavy Zipf(1.1) id stream, mean bags
    with empty ones, ids out of range and positions outside every bag, a
    bf16 table of pooled mean bags, and one row of ``HOT_COUNT``
    contributions among 131,072 single-row bags (the fold's worst case:
    ~3,440 chunk pieces)."""
    rng = np.random.default_rng(seed)
    cfg, R, B, foff = _dcn()

    def path_ids(n):
        ids = np.stack([rng.integers(0, v, B) for v in cfg.vocab_sizes], 1)
        return (ids + foff).reshape(-1)

    def hot_ids(n):
        ids = rng.integers(0, 1 << 20, n)
        ids[rng.permutation(n)[:HOT_COUNT]] = HOT_ROW
        return ids
    nb = B * cfg.n_sparse
    ones = np.ones(nb, np.int64)
    mixed = rng.integers(0, 9, 65536)
    mixed[rng.random(65536) < 0.2] = 0
    return [
        bwd_case(seed, "dcn-v2 train_batch", R, 16, torch.float32, ones,
                 path_ids, "sum", device=device),
        bwd_case(seed + 1, "zipf(1.1) ids", R, 16, torch.float32, ones,
                 lambda n: rng.zipf(1.1, n) % R, "sum", device=device),
        bwd_case(seed + 2, "mean, empty bags, clipped ids, outside positions",
                 R, 16, torch.float32, mixed,
                 lambda n: rng.integers(-100, R + 100, n), "mean",
                 lo=1000, hi=5000, device=device),
        bwd_case(seed + 3, "bf16 table, pooled mean bags", 1 << 20, 128,
                 torch.bfloat16, rng.integers(0, 41, 4096),
                 lambda n: rng.zipf(1.05, n) % (1 << 20), "mean",
                 device=device),
        bwd_case(seed + 4, f"one row of {HOT_COUNT} contributions", 1 << 20,
                 16, torch.float32, np.ones(131_072, np.int64), hot_ids,
                 "sum", device=device),
    ]


# (D, table dtype) of width_cases: one, two and five-wide lanes, rows of
# 4, 40 and 36 bytes (segments shared by rows), and D 16 with grad_out at
# an odd fp32 address (one fp32 a lane).
WIDTHS = ((1, torch.float32), (2, torch.bfloat16), (10, torch.float32),
          (18, torch.bfloat16), (16, torch.float32))


def width_cases(seed: int = 0, device="cuda") -> list:
    """Small calls at each lane width and row layout the launch takes
    (``WIDTHS``), sum and mean, over 900 rows whole and in three windows:
    bags of 0-8 rows (a fifth empty) after 5 unused positions and before
    7, ids clipped at both ends, a Zipf-heavy id stream and 2,200
    single-row bags of one row (a run over 68 chunks): (name, grad_out,
    indices, offsets, mode, R, dtype, row_lo, row_hi)."""
    rng = np.random.default_rng(seed)
    R, B, hot = 900, 160, 2200
    out = []
    for D, dt in WIDTHS:
        for mode in ("sum", "mean"):
            lens = rng.integers(0, 9, B)
            lens[rng.random(B) < 0.2] = 0
            lens = np.concatenate([lens[:B // 2], np.ones(hot, np.int64),
                                   lens[B // 2:]])
            off = np.concatenate([[5], 5 + np.cumsum(lens)])
            n = int(off[-1]) + 7
            idx = rng.zipf(1.3, n) % (R + 40) - 20
            a = int(off[B // 2])
            idx[a:a + hot] = R // 3
            idx[:3] = (-9, R + 5, R - 1)
            flat = torch.as_tensor(rng.normal(size=len(lens) * D + 1)
                                   .astype(np.float32), device=device)
            g = (flat[1:] if D == 16 else flat[:-1]).view(len(lens), D)
            i = torch.as_tensor(idx.astype(np.int32), device=device)
            o = torch.as_tensor(off.astype(np.int32), device=device)
            for lo, hi in [(0, R)] + [(k * R // 3, (k + 1) * R // 3)
                                      for k in range(3)]:
                out.append((f"D={D} {str(dt)[6:]} {mode} rows [{lo}, {hi})",
                            g, i, o, mode, R, dt, lo, hi))
    return out


def rank_windows(seed: int, device="cuda") -> list:
    """Phase 6r's windowed DCN-v2 backward: the ids of its last step
    (``np.random.default_rng([seed, RANK_STEP])``, uniform per field as
    ``chip_smoke.recsys_batch`` draws them, at B ``RANK_B``) as single-row
    bags, a seeded fp32 gradient, and each of the ``RANKS`` ranks' row
    windows of the padded table: (name, grad_out, indices, offsets,
    mode, R, dtype, row_lo, row_hi)."""
    cfg, R, _, foff = _dcn()
    rng = np.random.default_rng([seed, RANK_STEP])
    sparse = np.stack([rng.integers(0, v, RANK_B, dtype=np.int32)
                       for v in cfg.vocab_sizes], 1)
    idx = torch.as_tensor((sparse + foff).reshape(-1).astype(np.int32),
                          device=device)
    n = idx.numel()
    off = torch.arange(n + 1, dtype=torch.int32, device=device)
    g = torch.randn(n, cfg.embed_dim, device=device,
                    generator=torch.Generator(device).manual_seed(seed))
    return [(f"6r dcn-v2 window {k}/{RANKS}", g, idx, off, "sum", R,
             torch.float32, k * R // RANKS, (k + 1) * R // RANKS)
            for k in range(RANKS)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE.parents[3],
                    help="root of the checkout whose kernel is timed")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0,
                    help="chip_smoke.py's seed (phases 6r and 10 use 0)")
    args = ap.parse_args(argv)
    timing = _timing()
    sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.kernels import embedding_bag as keb
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": str(args.root), "card": card,
                      "package": keb.__file__}), flush=True)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    ok = True
    for c in bwd_cases(args.seed):
        ok &= time_one(c[0], c[1:], {}, keb, timing, flush, args.reps)
        torch.cuda.empty_cache()
    for name, *a, lo, hi in rank_windows(args.seed):
        ok &= time_one(name, a, dict(row_lo=lo, row_hi=hi), keb, timing,
                       flush, args.reps)
    return 0 if ok else 1


def time_one(name, a, k, keb, timing, flush, reps: int) -> bool:
    """Check and time one call ``keb.embedding_bag_backward(*a, **k)``;
    print its line; return whether every check held."""
    g, idx, off, mode, R, dtype = a

    def call():
        return keb.embedding_bag_backward(*a, **k)
    got = call()
    again = call()
    torch.cuda.synchronize()
    checks = dict(repeat_equal=torch.equal(got.view(torch.int16),
                                           again.view(torch.int16)))
    del again
    order = in_order_backward(*a, **k)
    checks["equal_in_order"] = torch.equal(got.view(torch.int16),
                                           order.view(torch.int16))
    del order
    sha = hashlib.sha256(got.view(torch.uint8).cpu().numpy()
                         .tobytes()).hexdigest()
    rows = got.shape[0]
    del got
    torch.cuda.empty_cache()
    parts, busy = timing.profiled_parts(call, reps=reps)
    need = bound_bytes(rows, dtype, g, idx, off)
    print(json.dumps(dict(
        call=name, bags=g.shape[0], positions=idx.numel(), rows=rows,
        D=g.shape[1], dtype=str(dtype)[6:], mode=mode,
        window=[k.get("row_lo", 0), k.get("row_hi", R)],
        ms=timing.cuda_ms(call, reps=reps),
        ms_cold=timing.cuda_ms_cold(call, flush, reps=reps),
        device_ms=busy,
        parts={n: round(t, 5) for n, t in sorted(parts.items(),
                                                 key=lambda kv: -kv[1])},
        bytes=need, bound_ms=need / HBM_BYTES_PER_S * 1e3, sha256=sha,
        **checks)), flush=True)
    return all(checks.values())


if __name__ == "__main__":
    sys.exit(main())
