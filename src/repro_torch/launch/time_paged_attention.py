"""Time one checkout's ``paged_attention`` kernel with this checkout's
timers, so two checkouts timed in one call share one yardstick.

    python src/repro_torch/launch/time_paged_attention.py [--root DIR]

``DIR`` (this checkout by default) is the root of the checkout whose
``src/repro_torch`` is imported and whose kernels are built, into its own
``_build``; the timers always come from this file's checkout
(``kernels/timing.py``, loaded by path).  To compare a parent commit with
a change, unpack the parent into a directory that ``.gitignore`` lists
and run parent, change, change, parent in one job on one card.

Shapes: ``chip_smoke.py`` phase 5's three timed shapes at TinyLlama's
heads (Hkv 4, G 8, D 64), bf16 q and heaps of 2,688 pages: B = 32 rows
at 2,048 tokens, B = 1 at 2,048, and B = 32 at the lengths of phase 5's
final serving state.  For each it prints one JSON line: the head-start
event timer warm (``ms``), each launch alone after the L2 is overwritten
(``ms_cold``), the event timer without a head start (``ms_no_head_start``),
the profiler's mean kernel duration (``device_ms``), the byte bound and
the max abs error against the checkout's plain version.
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
PAGE = 64
HBM_BYTES_PER_S = 3.35e12
HKV, G, D = 4, 8, 64            # TinyLlama-1.1B's KV heads, group, d_head
HEAP_PAGES = 2688               # phase 5's Z_kv heap: 172,032 slots
FINAL_STATE_LENS = [324, 180, 516, 156, 2132, 2032, 180, 1972, 280, 168,
                    212, 1984, 2116, 876, 2048, 1404, 1972, 2140, 260, 136,
                    180, 144, 240, 208, 452, 536, 168, 2132, 192, 1528, 444,
                    428]        # phase 5's final serving state, seed 0
SHAPES = (("B=32 x 2048", [2048] * 32, 32),
          ("B=1 x 2048", [2048], 32),
          ("final serving state", FINAL_STATE_LENS, 34))


def _timing():
    spec = importlib.util.spec_from_file_location(
        "_kernel_timing", HERE.parent.parent / "kernels" / "timing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case(rng, lens, NP):
    dev = torch.device("cuda")
    B = len(lens)
    table = rng.permutation(HEAP_PAGES)[:B * NP].reshape(B, NP)
    need = [min(-(-n // PAGE), NP) for n in lens]
    for b, k in enumerate(need):
        table[b, k:] = -1
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, HKV, G, D, device=dev, generator=g).bfloat16()
    kh = torch.randn(HKV, HEAP_PAGES * PAGE, D, device=dev,
                     generator=g).bfloat16()
    vh = torch.randn_like(kh)
    nbytes = (sum(need) * PAGE * D * 2 * 2 * HKV + q.numel() * (2 + 4)
              + table.size * 4 + B * 4)
    return (q, kh, vh, torch.as_tensor(table, dtype=torch.int32, device=dev),
            torch.as_tensor(lens, dtype=torch.int32, device=dev)), nbytes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE.parents[3],
                    help="root of the checkout whose kernel is timed")
    ap.add_argument("--reps", type=int, default=20)
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
    rng = np.random.default_rng(0)
    for name, lens, NP in SHAPES:
        call_args, nbytes = _case(rng, lens, NP)

        def call(a=call_args):
            return ops.paged_attention(*a)
        err = float((call() - ref.paged_attention_ref(*call_args))
                    .abs().max())
        dev_ms, seen = timing.profiled_ms(call, "paged_attention",
                                          reps=args.reps)
        print(json.dumps(dict(
            shape=name, ms=timing.cuda_ms(call, reps=args.reps),
            ms_cold=timing.cuda_ms_cold(call, flush, reps=args.reps),
            ms_no_head_start=timing.cuda_ms(call, reps=args.reps,
                                            head_start=False),
            device_ms=dev_ms, kernels_seen=seen, bytes=nbytes,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, max_abs_err=err)),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
