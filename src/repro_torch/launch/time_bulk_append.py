"""Time one checkout's ``bulk_append`` kernel at the ingest path's calls
with this checkout's timers, so two checkouts timed in one call share one
yardstick.

    python src/repro_torch/launch/time_bulk_append.py --root DIR

The calls are rebuilt here from ``chip_smoke.py``'s seeds, the same for
every checkout:

1. phase 2's batch: the fifth 4096-tweet batch of the seed-0 Zipf
   stream over 2**20 terms (:func:`stream_prefix`) planned into the
   full-width pools (:data:`PHASE2_POOLS`, 373,293,056 slots) after the
   first four: 286,720 lanes, most of them pads;
2. one shard's batch at phase 8a's shape: shard 0's residue substream of
   the same stream (1024 tweets a batch, 71,680 lanes) into 8a's pools
   a shard (:data:`SHARD_POOLS`);
3. a dense call: 286,720 lanes that all land in all three streams
   (distinct random heap slots and terms, no pads) on call 1's state,
   to time the store path.

``DIR`` (this checkout by default) is the root of the checkout whose
``src/repro_torch`` is imported and whose kernels are built, into its own
``_build``; the timers always come from this file's checkout
(``kernels/timing.py``, loaded by path).  To compare a parent commit with
a change, unpack the parent into a directory that ``.gitignore`` lists
and run parent, change, change, parent in one job on one card.

For each call it prints one JSON line: the lane and landing counts, the
wrapper's time warm (``ms``), each call alone after the L2 is
overwritten (``ms_cold``) and by the profiler (``device_ms``; for calls
1 and 2 also ``in_batch_ms``, the kernel inside whole ingests of the
batch); the
bound as the call needs it (:func:`bound_bytes`: every lane's three
addresses, the values of the landing lanes read and written) and the old
count of all seven streams for every lane; whether the result is
bit-equal to ``bulk_append_ref`` on clones of one state; and the SHA-256
of the seven streams (equal across checkouts: the plan is the same) and
of heap, tail and freq after one call from that state (equal across
checkouts when the kernels agree bit for bit).  It exits 1 if any check
fails.

This module also holds the kernel's edge cases (:func:`edge_cases`, on
one state made by :func:`edge_state`), which ``chip_smoke.py`` phase 2
runs on the card and the CPU tests run through a mirror of the kernel's
walk.  It imports nothing but torch and numpy at its top.
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
BATCH = 4096                 # chip_smoke's arrival batch
VOCAB = 1 << 20              # the full-width stream's terms
# the full-width stream: a 2**23-tweet segment, 2**20 more and one traced
# batch (chip_smoke.index_stream)
STREAM_DOCS = (1 << 23) + (1 << 20) + BATCH
# slices a pool that chip_smoke.size_layout gives that stream (its
# "stream:" line) and shard_layout its 8a prefix (its "sharded:" line);
# phase 2 checks the first against its own layout at full width
PHASE2_POOLS = (2097152, 2097152, 524288, 131072)
SHARD_POOLS = (524288, 65536, 8192, 2048)
SHARDS = 4
DENSE_LANES = 286_720        # phase 2's lane count
EDGE_H, EDGE_V = 1 << 22, 1 << 20   # the edge cases' heap and terms


def _timing():
    spec = importlib.util.spec_from_file_location(
        "_kernel_timing", HERE.parent.parent / "kernels" / "timing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stream_prefix(first: int, vocab: int = VOCAB,
                  n_docs: int = STREAM_DOCS, seed: int = 0) -> np.ndarray:
    """The first ``first`` tweets of ``synth.zipf_corpus`` at chip_smoke's
    spec (mean length 11, at most 70 terms, alpha 1.0): the generator's
    draws in the same order, the term draws only as far as those tweets
    need (numpy's ``choice`` with ``p`` searches the normalised
    cumulative sum of ``rng.random`` draws, side="right")."""
    from repro_torch.data import synth
    rng = np.random.default_rng(seed)
    probs = synth._zipf_probs(vocab, 1.0)
    perm = rng.permutation(vocab)
    lens = np.clip(rng.poisson(11, n_docs), 1, 70)[:first]
    cdf = probs.cumsum()
    cdf /= cdf[-1]
    u = rng.random(int(lens.sum()))
    docs = np.full((first, 70), -1, np.int32)
    docs[np.arange(70)[None, :] < lens[:, None]] = perm[
        np.searchsorted(cdf, u, side="right")]
    return docs


def planned_batch(pools, docs: np.ndarray, batch: int, device="cuda"):
    """``docs`` ingested in batches of ``batch`` tweets into the production
    layout of ``pools`` slices a pool, all but the last batch, which is
    planned: ``(state, the seven streams, again)``, where ``again()``
    returns a callable that ingests that last batch (plan and kernel)
    into one clone of the pool state, once more at each call."""
    from repro_torch.core import pointers
    from repro_torch.core.index import ActiveSegment, flatten
    seg = ActiveSegment(pointers.production_layout(pools), VOCAB,
                        device=device)
    for s in range(0, docs.shape[0] - batch, batch):
        seg.ingest(docs[s: s + batch])
    last = torch.as_tensor(docs[-batch:], device=seg.state.heap.device)
    terms, plist, valid = flatten(last, seg.next_docid)
    scat, _, _, _ = seg._ingest.plan(seg.state, terms, plist,
                                     torch.zeros_like(terms), valid)
    st = seg.state

    def again():
        box = [st._replace(heap=st.heap.clone(), tail=st.tail.clone(),
                           freq=st.freq.clone())]

        def call():
            box[0] = seg._ingest(box[0], terms, plist, None, valid)
        return call
    return (st.heap, st.tail, st.freq), scat, again


def phase2_call(device="cuda"):
    """Call 1: ``(name, state, streams, again)`` (:func:`planned_batch`)."""
    return ("phase 2's batch", *planned_batch(
        PHASE2_POOLS, stream_prefix(5 * BATCH), BATCH, device))


def shard_call(device="cuda"):
    """Call 2: shard 0's fifth batch (1024 local tweets) of 8a's stream."""
    docs = stream_prefix(5 * BATCH)[0::SHARDS]
    return ("a shard's batch at 8a's shape",
            *planned_batch(SHARD_POOLS, docs, BATCH // SHARDS, device))


def _uniq(rng, cap: int, k: int) -> np.ndarray:
    return rng.choice(cap, k, replace=False).astype(np.int64)


def _streams(post_addr, ptr_addr, term_idx, rng, device, offset=()):
    """The seven streams of the given addresses with seeded uint32 values
    and int32 freqs; stream s in ``offset`` is a view at storage offset 1
    (its base one element past an allocation's)."""
    n = len(post_addr)
    vals = [rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.int64)
            for _ in range(3)]
    host = (post_addr, vals[0], ptr_addr, vals[1], term_idx, vals[2],
            rng.integers(0, 1 << 31, n).astype(np.int32))
    out = []
    for s, x in enumerate(host):
        t = torch.as_tensor(np.asarray(x), device=device)
        if s in offset:
            buf = torch.empty(n + 1, dtype=t.dtype, device=device)
            buf[1:] = t
            t = buf[1:]
        out.append(t)
    return tuple(out)


def _prefix_case(n: int, rng, H: int, V: int, device, offset=()):
    """``n`` lanes shaped like a plan's: every lane of the first sixth
    lands a posting, 4% of them a pointer and 40% a term head; the rest
    are pads that skip at distinct out-of-range addresses."""
    live = -(-n // 6)
    lane = np.arange(n, dtype=np.int64)
    slots = _uniq(rng, H, 2 * live)
    post = np.where(lane < live, np.resize(slots[:live], n), H + lane)
    ptr_live = (lane < live) & (rng.random(n) < 0.04)
    ptr = np.where(ptr_live, np.resize(slots[live:], n), H + lane)
    term_live = (lane < live) & (rng.random(n) < 0.4)
    term = np.where(term_live, np.resize(_uniq(rng, V, live), n), V + lane)
    return _streams(post, ptr, term, rng, device, offset)


def edge_lengths(sms: int) -> tuple:
    """Lane counts at the edges of the kernel's walk: a warp's pairs, a
    warp tile, two and a CTA's tiles and one lane more or less, one wave
    of the largest grid and one lane more or less, 8a's and phase 2's
    batches."""
    from repro_torch.kernels import bulk_append as kba
    cta = kba.THREADS * kba.LANES
    wave = kba.CTAS_PER_SM * sms * cta
    return (1, 2, 31, 32, 33, 63, 64, 65, 127, 128, 129, cta - 1, cta,
            cta + 1, wave - 1, wave, wave + 1, 71_680, 286_720)


def edge_state(seed: int = 0, device="cuda"):
    """The edge cases' one state: ``EDGE_H`` heap slots and ``EDGE_V``
    terms of seeded uint32 words (as int64) and int32 counts."""
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.integers(0, 1 << 32, EDGE_H,
                                         dtype=np.uint64).astype(np.int64),
                            device=device),
            torch.as_tensor(rng.integers(0, 1 << 32, EDGE_V,
                                         dtype=np.uint64).astype(np.int64),
                            device=device),
            torch.as_tensor(rng.integers(0, 1 << 20, EDGE_V)
                            .astype(np.int32), device=device))


def edge_cases(sms: int = 132, seed: int = 0, device="cuda") -> list:
    """``(name, seven streams)`` for :func:`edge_state`'s state: each of
    :func:`edge_lengths` shaped like a plan's lanes; phase 2's length
    with all seven streams, and with every other one, at storage offset
    1 (one lane a load); every lane skipping; every lane landing in all
    three streams; lanes landing at random; and the addresses -1, H - 1,
    H, 2**40 and -2**40 (heap), V - 1, V, -1 and 2**40 (terms)."""
    rng = np.random.default_rng(seed)
    H, V = EDGE_H, EDGE_V
    cases = [(f"n={n}", _prefix_case(n, rng, H, V, device))
             for n in edge_lengths(sms)]
    n = DENSE_LANES
    cases.append(("all seven streams at storage offset 1",
                  _prefix_case(n, rng, H, V, device, offset=range(7))))
    cases.append(("streams 0, 2, 4, 6 at storage offset 1",
                  _prefix_case(n, rng, H, V, device, offset=(0, 2, 4, 6))))
    lane = np.arange(n, dtype=np.int64)
    cases.append(("every lane skips",
                  _streams(H + lane, H + n + lane, V + lane, rng, device)))
    slots = _uniq(rng, H, 2 * n)
    cases.append(("every lane lands",
                  _streams(slots[:n], slots[n:], _uniq(rng, V, n), rng,
                           device)))
    land = [rng.random(n) < r for r in (0.5, 0.1, 0.3)]
    slots = _uniq(rng, H, 2 * n)
    cases.append(("lanes land at random", _streams(
        np.where(land[0], slots[:n], H + lane),
        np.where(land[1], slots[n:], H + lane),
        np.where(land[2], _uniq(rng, V, n), V + lane), rng, device)))
    k = 64
    lane = np.arange(k, dtype=np.int64)
    post, ptr, term = H + lane, H + k + lane, V + lane
    post[:5] = (-1, H - 1, H, 1 << 40, -(1 << 40))
    ptr[:5] = (H, -1, 1 << 40, H - 2, 0)
    term[:5] = (V - 1, V, -1, 1 << 40, 0)
    cases.append(("addresses -1, H - 1, H, 2**40, V - 1 and V",
                  _streams(post, ptr, term, rng, device)))
    return cases


def landing(scat, H: int, V: int):
    """The lanes that land in each stream: posting, pointer and term
    masks (an address in ``[0, H)``, ``[0, H)`` and ``[0, V)``)."""
    return [(a >= 0) & (a < cap)
            for a, cap in ((scat[0], H), (scat[2], H), (scat[4], V))]


def bound_bytes(scat, H: int, V: int) -> dict:
    """The bytes a call must move: every lane's three int64 addresses
    read; a landing lane's value read and written (8 bytes a posting or
    pointer, 12 a term's tail and freq).  Beside it the old count, all
    seven streams (52 bytes) for every lane and the landed writes."""
    n = scat[0].shape[0]
    landed = [int(m.sum()) for m in landing(scat, H, V)]
    moved = 8 * (landed[0] + landed[1]) + 12 * landed[2]
    return dict(lanes=n, postings=landed[0], pointers=landed[1],
                terms=landed[2], bytes=24 * n + 2 * moved,
                bytes_all_lanes=n * (6 * 8 + 4) + moved)


def sha256(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE.parents[3],
                    help="root of the checkout whose kernel is timed")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    timing = _timing()
    sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.kernels import bulk_append as kba
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": str(args.root), "card": card,
                      "package": kba.__file__}), flush=True)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    name, state, scat, again = phase2_call()
    ok = time_one(name, state, scat, kba, ref, timing, flush, args.reps,
                  again)
    del scat, again
    name, shard, scat, again = shard_call()
    ok &= time_one(name, shard, scat, kba, ref, timing, flush, args.reps,
                   again)
    del shard, scat, again
    rng = np.random.default_rng(1)
    slots = _uniq(rng, state[0].shape[0], 2 * DENSE_LANES)
    dense = _streams(slots[:DENSE_LANES], slots[DENSE_LANES:],
                     _uniq(rng, VOCAB, DENSE_LANES), rng, "cuda")
    ok &= time_one("every lane lands (dense, on call 1's state)", state,
                   dense, kba, ref, timing, flush, args.reps)
    return 0 if ok else 1


def time_one(name, state, scat, kba, ref, timing, flush, reps: int,
             again=None) -> bool:
    """Check and time ``kba.bulk_append`` on clones of ``state``; print
    the call's line; return whether the check held.  ``again`` (see
    :func:`planned_batch`) adds ``in_batch_ms``: the kernel's device
    time by the profiler inside whole ingests of the batch, its streams
    just written by the plan, as the path runs it."""
    H, V = state[0].shape[0], state[1].shape[0]
    got = [t.clone() for t in state]
    want = [t.clone() for t in state]
    kba.bulk_append(*got, *scat)
    ref.bulk_append_ref(*want, *scat)
    torch.cuda.synchronize()
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    del want
    state_sha = sha256(*got)

    def call():
        kba.bulk_append(*got, *scat)
    dev_ms, seen = timing.profiled_ms(call, "bulk_append_kernel", reps=reps)
    in_batch = None if again is None else timing.profiled_ms(
        again(), "bulk_append_kernel", reps=reps)[0]
    b = bound_bytes(scat, H, V)
    live = landing(scat, H, V)
    plan = getattr(kba, "launch_plan", None)
    line = dict(
        call=name, heap=H, vocab=V, **b,
        skip_all=int((~(live[0] | live[1] | live[2])).sum()),
        plan=None if plan is None else plan(
            b["lanes"], torch.cuda.get_device_properties(0)
            .multi_processor_count,
            [t.data_ptr() for t in scat]).__dict__,
        ms=timing.cuda_ms(call, reps=reps),
        ms_cold=timing.cuda_ms_cold(call, flush, reps=reps),
        device_ms=dev_ms, kernels_seen=seen, in_batch_ms=in_batch,
        bound_ms=b["bytes"] / HBM_BYTES_PER_S * 1e3,
        bound_all_lanes_ms=b["bytes_all_lanes"] / HBM_BYTES_PER_S * 1e3,
        streams_sha256=sha256(*scat), state_sha256=state_sha,
        equal_ref=equal)
    print(json.dumps(line), flush=True)
    del got
    torch.cuda.empty_cache()
    return equal


if __name__ == "__main__":
    sys.exit(main())
