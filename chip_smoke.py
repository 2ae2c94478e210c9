"""Drive the PyTorch/CUDA port (the streaming index, the paged-KV
decoder server and recsys serving) on one GPU.

    python3 chip_smoke.py

Phases, in order (any failure raises and exits non-zero):

  1. the card (``nvidia-smi``), torch/CUDA versions, the kernel build;
  2. every CUDA kernel against its plain torch version on the card, at
     the main path's shapes, bit for bit (the scored kernel at three
     thresholds: none, about half the blocks skipped, all skipped;
     ``intersect_mask`` twice on each of its edge cases and on three
     pairs padded to max_len: head vs torso, torso vs head, head vs an
     all-pad list) — plus its time, the plain version's, one library
     call's and the bound the card's memory rate sets (for
     ``intersect_mask`` also L2-flushed and by the profiler);
  3. the main path at full width: a Zipf(1.0) tweet stream over a 2**20
     term vocabulary into Earlybird's 2**23-tweet segment under the
     paper's production pools Z^g = <1, 4, 7, 11>, in 4096-tweet arrival
     batches; one rollover (freeze + slice reclamation), 2**20 more
     tweets into the recycled pools, then a 64-query AOL-like batch
     through the batched conjunctive / disjunctive / phrase / top-k /
     scored top-k (k = 10) / exhaustive scored routes, held against a
     numpy brute force over the stream (score = sum of min(tf, 255),
     ranked by score desc, docid desc);
  4. compaction, the sequential oracle route and durability at a
     smaller depth: 2**16-tweet segments, >= 3 rollovers with
     CompactionPolicy(fanout=2), every query kind batched and
     ``batched=False`` (the per-segment kernels), which must agree bit
     for bit and with the brute force (the sequential route's
     ``intersect_mask`` calls are replayed under the profiler for their
     summed device time); every batch journaled and a
     snapshot taken mid-stream, then the engine dropped and recovered
     on the card: equal fingerprint and answers, and a truncated
     archive must raise ``CorruptSnapshotError``;
  5. paged-KV decoder serving at TinyLlama-1.1B's full width (22 layers,
     d_model 2048, 32 query / 4 KV heads, d_head 64, random weights
     from a seed) with the KV store on the slice-pool allocator, Z_kv =
     <6, 8, 10>: the ``paged_attention`` kernel against its plain
     version in fp32 and bf16 at the serving shapes, at B = 1 across
     the split edges (lengths 1 to max_len + 100) and at every registry
     LM head shape, each call twice and bit-equal; its times, warm and
     L2-flushed, beside the byte bound and gather + sdpa, at B = 32 and
     B = 1 at full length and on the final serving state; the paged decode
     against the dense decode in fp32 (4 sequences in lockstep, every
     greedy token equal); then 64 requests on 32 slots (max_len 2048) in
     bf16, with the kernel held against its plain version again on the
     final serving state.

  6. recsys serving through the ``embedding_bag`` kernel (every table
     read of the forwards is one launch), random weights from a seed:
     DCN-v2 exactly as published (fp32, a 2.01 GiB table) at serve_p99
     (B = 512), serve_bulk (B = 262,144) and retrieval_cand (1 user, 10**6
     candidates); xDeepFM and DIEN as published at serve_p99; DLRM-MLPerf
     at its published widths with a bf16 table (44.8 GiB; cut: the fp32
     table does not fit one card) at serve_p99.  Checks: (a) the kernel
     against its plain version on every call of each forward (single-row
     bags bit for bit, every bag bit-equal to the in-order sum), (b) on
     synthetic bags (lengths 0-64, empty, N = 0, D 1/10/16/18/128, fp32
     and bf16, ids out of range; bags longer than a chunk, offsets[0] >
     0, a malformed CSR, misaligned table views, the ten path shapes at
     100,000 rows), (c) each output against the same forward with plain
     lookups, (d) the launch count; the four reduced configs on the card
     against the CPU.  Reports ms per batch, samples/s, a traced batch's
     idle share and top ops, peak memory, and the kernel (warm, flushed,
     profiler) against its bound, its plain version and
     ``F.embedding_bag`` at each of the ten calls the cells make.

``--paged-only`` runs phases 1 and 5 alone, ``--recsys-only`` phases 1
and 6 (short rehearsals); ``--intersect-calls PATH`` phases 1 and 4,
saving the sequential route's ``intersect_mask`` inputs to ``PATH`` for
``launch/time_intersect_mask.py --calls``; ``--bag-calls PATH`` phase 1
and one call of each phase-6 cell, saving its ten ``embedding_bag``
calls to ``PATH`` for ``launch/time_embedding_bag.py --calls``.

The last two lines are the kernel table as JSON, the card's name and
power limit, and the result line.  The script imports only torch, numpy
and the port (``src/repro_torch``); it needs one CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
sys.path.insert(0, _SRC)

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import analytical  # noqa: E402
from repro_torch.core import convert as cconv  # noqa: E402
from repro_torch.core import pointers  # noqa: E402
from repro_torch.core import recovery  # noqa: E402
from repro_torch.core.index import ActiveSegment, flatten  # noqa: E402
from repro_torch.core.lifecycle import LifecycleEngine  # noqa: E402
from repro_torch.core.segments import CompactionPolicy  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.kernels import _cuda, ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa_kernel  # noqa: E402
from repro_torch.kernels.timing import (cuda_ms, cuda_ms_cold,  # noqa: E402
                                        profiled_ms, profiled_total_ms)
from repro_torch.launch import serve as paged_serve  # noqa: E402
from repro_torch.launch import time_embedding_bag as tbag  # noqa: E402
from repro_torch.launch import time_intersect_mask as tim  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402
from repro_torch.paged import kv_cache as kv  # noqa: E402
from repro_torch.paged import serve_model as sm  # noqa: E402
from repro_torch.train import steps as rsteps  # noqa: E402
from repro_torch.kernels.segment_intersect import (  # noqa: E402
    SCORE_MAX, SEG_BLOCK, attach_scores, decode_packed, decode_scores,
    decode_stacked, pack_docids, stack_packed, stack_scored)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BATCH = 4096                 # arrival batch: under a second of 2013 traffic
Z = (1, 4, 7, 11)            # the paper's production pools Z^g
REPLACES = {
    "bulk_append": "src/repro/kernels/bulk_append.py:87",
    "segment_intersect_mask_batched":
        "src/repro/kernels/segment_intersect.py:496",
    "intersect_mask": "src/repro/kernels/postings_intersect.py:102",
    "segment_intersect_mask": "src/repro/kernels/segment_intersect.py:366",
    "scored_intersect_batched":
        "src/repro/kernels/segment_intersect.py:753",
    "paged_attention": "src/repro/kernels/paged_attention.py:92",
    "embedding_bag": "src/repro/kernels/embedding_bag.py:61",
}
SOURCES = {
    "bulk_append": "src/repro_torch/csrc/bulk_append.cu",
    "segment_intersect_mask_batched":
        "src/repro_torch/csrc/segment_intersect.cu",
    "intersect_mask": "src/repro_torch/csrc/postings_intersect.cu",
    "segment_intersect_mask": "src/repro_torch/csrc/segment_intersect.cu",
    "scored_intersect_batched": "src/repro_torch/csrc/scored_intersect.cu",
    "paged_attention": "src/repro_torch/csrc/paged_attention.cu",
    "embedding_bag": "src/repro_torch/csrc/embedding_bag.cu",
}
SCORED_K = 10                # the scored top-k route's k


def log(msg: str) -> None:
    print(msg, flush=True)


def require_equal(name: str, got, want) -> int:
    """Bit-identity of a kernel's output with its plain version; returns
    the max absolute difference (0, or this raises)."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err or not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({bad} lanes differ)")
    return err


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# data: the tweet stream and the brute-force oracle
# ---------------------------------------------------------------------------
def make_stream(vocab: int, n_docs: int, seed: int) -> np.ndarray:
    spec = synth.CorpusSpec(vocab=vocab, n_docs=n_docs, mean_len=11,
                            max_len=70, alpha=1.0, seed=seed)
    return synth.zipf_corpus(spec)


class BruteForce:
    """Per-term (doc, position) lists straight from the stream matrix,
    built chunk by chunk on the host for the terms the queries use."""

    def __init__(self, docs: np.ndarray, terms, vocab: int,
                 chunk: int = 1 << 20):
        need = np.zeros(vocab + 1, bool)           # index -1 -> vocab
        need[np.asarray(sorted(set(terms)), np.int64)] = True
        rows, cols, vals = [], [], []
        for s in range(0, docs.shape[0], chunk):
            part = docs[s: s + chunk]
            r, c = np.nonzero(need[part])
            rows.append(r + s)
            cols.append(c)
            vals.append(part[r, c])
        rows, cols, vals = (np.concatenate(x) for x in (rows, cols, vals))
        order = np.argsort(vals, kind="stable")    # (doc, pos) order kept
        rows, cols, vals = rows[order], cols[order], vals[order]
        cut = np.searchsorted(vals, np.arange(vocab + 1))
        self.lists = {int(t): (rows[cut[t]: cut[t + 1]].astype(np.int64),
                               cols[cut[t]: cut[t + 1]].astype(np.int64))
                      for t in set(terms)}
        self._tf = {}

    def docs_of(self, t: int) -> np.ndarray:
        return self.tf_of(t)[0]

    def tf_of(self, t: int):
        """(ascending docs, term frequency in each) of one term."""
        t = int(t)
        if t not in self._tf:
            self._tf[t] = np.unique(self.lists[t][0], return_counts=True)
        return self._tf[t]

    def scored(self, terms):
        """Docs holding every term, ranked by sum of min(tf, 255) desc,
        then docid desc: (docs, scores)."""
        its = [self.tf_of(t) for t in terms]
        ids = its[0][0]
        for more, _ in its[1:]:
            ids = np.intersect1d(ids, more)
        sc = np.zeros(ids.size, np.int64)
        for uids, tf in its:
            sc += np.minimum(tf[np.searchsorted(uids, ids)], SCORE_MAX)
        order = np.lexsort((-ids, -sc))
        return ids[order], sc[order]

    def conjunctive(self, terms) -> np.ndarray:
        out = self.docs_of(terms[0])
        for t in terms[1:]:
            out = np.intersect1d(out, self.docs_of(t))
        return out[::-1]

    def disjunctive(self, terms) -> np.ndarray:
        out = self.docs_of(terms[0])
        for t in terms[1:]:
            out = np.union1d(out, self.docs_of(t))
        return out[::-1]

    def phrase(self, t1: int, t2: int) -> np.ndarray:
        d1, p1 = self.lists[int(t1)]
        d2, p2 = self.lists[int(t2)]
        k1 = d1 * 256 + p1
        hit = np.isin(k1 + 1, d2 * 256 + p2)
        return np.unique(d1[hit])[::-1]


def check_answers(kind: str, got, want) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{kind}: {len(got)} answers for "
                             f"{len(want)} queries")
    for i, (g, w) in enumerate(zip(got, want)):
        # scored answers are (docs, scores) pairs
        pairs = zip(g, w) if isinstance(w, tuple) else [(g, w)]
        for gx, wx in pairs:
            if not np.array_equal(gx, wx):
                raise AssertionError(
                    f"{kind} query {i}: engine returned {len(gx)} "
                    f"entries, brute force {len(wx)}")


def query_batch(docs, vocab: int, n: int, seed: int):
    qs = synth.query_log("aol", n, docs, vocab, seed=seed)
    queries = [tuple(int(t) for t in row if t >= 0) for row in qs]
    pairs = [(q[0], q[1] if len(q) > 1 else q[0]) for q in queries]
    return queries, pairs


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version, at main-path shapes
# ---------------------------------------------------------------------------
def _lists(rng, n_docs: int, densities):
    """Ascending docid sets of the given densities over one segment."""
    out = []
    for p in densities:
        if p <= 0:
            out.append(np.zeros(0, np.uint32))
            continue
        m = rng.random(n_docs) < p
        out.append(np.nonzero(m)[0].astype(np.uint32))
    return out


def _touched_bytes(a_ids, b, extra: int = 0):
    """Bytes of the distinct b-blocks some valid a-lane can match (the
    kernel's data-dependent reads: block entry + 32*bw int64 words, plus
    ``extra`` bytes per block)."""
    rows, nb = b.firsts.shape
    valid = a_ids != 0xFFFFFFFF
    j = torch.searchsorted(b.firsts.contiguous(), a_ids.contiguous(),
                           right=True) - 1
    j = torch.minimum(j, ((b.ns.long() - 1) // SEG_BLOCK)[:, None])
    ok = valid & (j >= 0) & (b.ns[:, None] > 0)
    key = torch.unique((torch.arange(rows, device=a_ids.device)[:, None]
                        * nb + j)[ok])
    bw = b.bws.reshape(-1)[key].long()
    return int((16 + 32 * bw * 8 + extra).sum())


def _list_bytes(bws, ns) -> int:
    """Bytes of the real (non-pad) blocks of a stack: block tables plus
    32*bw int64 payload words each."""
    nblk = (ns.long() + SEG_BLOCK - 1) // SEG_BLOCK
    real = (torch.arange(bws.shape[-1], device=bws.device)[None, :]
            < nblk[:, None])
    return int(((16 + 32 * bws.long() * 8) * real).sum())


def _scored_bytes(a, b, a_ids, live_blk) -> int:
    """Bytes the scored kernel must move: per real a-block its block
    entry and bmax (20 bytes); per live a-block its 32*bw payload and 32
    score words (int64 each); per b-block a live lane can match, its
    block entry, payload and score words; the int32 output."""
    nb = a.ids.firsts.shape[1]
    nblk = (a.ids.ns.long() + SEG_BLOCK - 1) // SEG_BLOCK
    real = torch.arange(nb, device=a_ids.device)[None, :] < nblk[:, None]
    live = real & live_blk
    a_live = torch.where(live.repeat_interleave(SEG_BLOCK, dim=1), a_ids,
                         torch.full_like(a_ids, 0xFFFFFFFF))
    per_live = (32 * a.ids.bws.long() + 32) * 8
    return (int(20 * real.sum()) + int((per_live * live).sum())
            + _touched_bytes(a_live, b.ids, extra=32 * 8)
            + a_ids.numel() * 4)


def _split_threshold(bound: np.ndarray, n_real: int) -> int:
    """The threshold that skips the share of a row's real blocks closest
    to one half (a block survives when its bound exceeds it)."""
    real = bound[:n_real]
    if real.size == 0:
        return -1
    cands = np.unique(real)
    skip = np.array([(real <= c).mean() for c in cands])
    return int(cands[np.argmin(np.abs(skip - 0.5))])


def intersect_edge_cases() -> int:
    """``intersect_mask`` on the card against its plain version on the
    edge cases of ``launch/time_intersect_mask.py`` (duplicated runs that
    straddle the kernel's tiles, empty valid prefixes, equal and
    disjoint lists, extreme values, several rows), sized from tiles of
    7, 64 and the kernel's 4,096: bit for bit, twice.  Returns the count."""
    n = 0
    for tile in (7, 64, 4096):
        for name, a, b in tim.edge_cases(tile):
            a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
            want = ref.intersect_mask_ref(a, b)
            for k in range(2):
                require_equal(f"intersect_mask/{name} at tile {tile} "
                              f"(call {k})", ops.intersect_mask(a, b), want)
            n += 1
    torch.cuda.synchronize()
    return n


def phase_kernels(docs: np.ndarray, layout, vocab: int, seg_docs: int,
                  q_rows: int, seed: int):
    dev = torch.device("cuda")
    rows = {}
    rng = np.random.default_rng(seed)

    # -- bulk_append on a real arrival batch into the full-size pools ---
    seg = ActiveSegment(layout, vocab, device="cuda")
    for i in range(4):
        seg.ingest(docs[i * BATCH:(i + 1) * BATCH])
    batch = torch.as_tensor(docs[4 * BATCH: 5 * BATCH], device=dev)
    terms, plist, valid = flatten(batch, seg.next_docid)
    scat, _, _, _ = seg._ingest.plan(
        seg.state, terms, plist, torch.zeros_like(terms), valid)
    st = seg.state
    k_out = [x.clone() for x in (st.heap, st.tail, st.freq)]
    r_out = [x.clone() for x in (st.heap, st.tail, st.freq)]
    ops.bulk_append(*k_out, *scat)
    ref.bulk_append_ref(*r_out, *scat)
    torch.cuda.synchronize()
    err = max(require_equal(f"bulk_append/{name}", g, w)
              for name, g, w in zip(("heap", "tail", "freq"), k_out, r_out))
    n = scat[0].shape[0]
    H, V = st.heap.shape[0], st.tail.shape[0]
    live = [(a >= 0) & (a < cap) for a, cap in
            ((scat[0], H), (scat[2], H), (scat[4], V))]
    landed = [int(m.sum()) for m in live]
    skips = n - landed[0]
    if skips == 0:
        raise AssertionError("bulk_append case has no skip lanes")
    nbytes = n * (6 * 8 + 4) + 8 * (landed[0] + landed[1]) + 12 * landed[2]
    pre = [(scat[0][live[0]], scat[1][live[0]]),
           (scat[2][live[1]], scat[3][live[1]]),
           (scat[4][live[2]], scat[5][live[2]]),
           (scat[4][live[2]], scat[6][live[2]])]

    def library():
        for tgt, (a, v) in zip((r_out[0], r_out[0], r_out[1], r_out[2]),
                               pre):
            tgt.index_put_((a,), v)

    rows["bulk_append"] = dict(
        ms=cuda_ms(lambda: ops.bulk_append(*k_out, *scat)),
        plain_ms=cuda_ms(lambda: ref.bulk_append_ref(*r_out, *scat)),
        library_ms=cuda_ms(library), bytes=nbytes, max_abs_err=err,
        shape=f"N={n} lanes ({landed[0]} postings, {landed[1]} pointers, "
              f"{landed[2]} terms land; {skips} skip), heap {H}")
    # the same call L2-flushed, and the profiler's own kernel durations:
    # its 15.5 MB fit the 50 MB L2, so warm repeats may beat HBM
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    r = rows["bulk_append"]
    r["ms_cold"] = cuda_ms_cold(lambda: ops.bulk_append(*k_out, *scat), flush)
    r["device_ms"], seen = profiled_ms(
        lambda: ops.bulk_append(*k_out, *scat), "bulk_append_kernel")
    log(f"bulk_append: {r['ms_cold']:.4f} ms L2-flushed; profiler "
        + ("not measured" if r["device_ms"] is None else
           f"{r['device_ms']:.4f} ms per launch") + f" ({seen} kernels "
        f"seen); bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    del seg, st, k_out, r_out, pre, flush
    torch.cuda.empty_cache()

    # -- the segment kernels on lists shaped like a full segment's ------
    # a query batch's driving pairs: a head term, torso and tail terms,
    # a pad row (empty list); densities give bw 1, 2 and 4 blocks
    dens_a = [0.55, 0.06, 0.004, 0.0004, 3e-5, 2e-6, 0.0, 0.3][:q_rows]
    dens_b = [0.3, 0.5, 0.02, 0.55, 0.001, 0.2, 0.4, 0.0][:q_rows]
    la = _lists(rng, seg_docs, dens_a)
    lb = _lists(rng, seg_docs, dens_b)
    pa = [pack_docids(x) for x in la]
    pb = [pack_docids(x) for x in lb]
    bws = np.concatenate([np.asarray(p.bws[: -(-p.n // SEG_BLOCK)])
                          for p in pa + pb if p.n])
    if not {1, 2, 4} <= set(bws.tolist()):
        raise AssertionError(f"kernel cases miss a byte width: "
                             f"{sorted(set(bws.tolist()))}")
    sa = stack_packed(pa).to(dev)
    sb = stack_packed(pb).to(dev)
    got = ops.segment_intersect_mask_batched(sa, sb)
    want = ref.segment_intersect_mask_batched_ref(sa, sb)
    torch.cuda.synchronize()
    err = require_equal("segment_intersect_mask_batched", got, want)
    a_ids, b_ids = decode_stacked(sa), decode_stacked(sb)
    rows["segment_intersect_mask_batched"] = dict(
        ms=cuda_ms(lambda: ops.segment_intersect_mask_batched(sa, sb)),
        plain_ms=cuda_ms(
            lambda: ref.segment_intersect_mask_batched_ref(sa, sb)),
        library_ms=cuda_ms(lambda: torch.gather(
            b_ids, 1, torch.searchsorted(b_ids, a_ids).clamp_(
                max=b_ids.shape[1] - 1)) == a_ids),
        bytes=_list_bytes(sa.bws, sa.ns) + _touched_bytes(a_ids, sb)
        + got.numel() * 4, max_abs_err=err,
        hits=int(got.sum()),
        shape=f"N={sa.firsts.shape[0]} rows, NB={sa.n_blocks} blocks "
              f"(W={sa.n_blocks * SEG_BLOCK}), PW={sa.n_words}")

    # -- single pair: the head list against a torso list ---------------
    a1, b1 = pa[0].to(dev), pb[2].to(dev)
    got = ops.segment_intersect_mask(a1, b1)
    want = ref.segment_intersect_mask_ref(a1, b1)
    torch.cuda.synchronize()
    err = require_equal("segment_intersect_mask", got, want)
    d_a, d_b = decode_packed(a1), decode_packed(b1)
    s1a, s1b = stack_packed([pa[0]]).to(dev), stack_packed([pb[2]]).to(dev)
    rows["segment_intersect_mask"] = dict(
        ms=cuda_ms(lambda: ops.segment_intersect_mask(a1, b1)),
        plain_ms=cuda_ms(lambda: ref.segment_intersect_mask_ref(a1, b1)),
        library_ms=cuda_ms(lambda: torch.gather(
            d_b, 0, torch.searchsorted(d_b, d_a).clamp_(
                max=d_b.shape[0] - 1)) == d_a),
        bytes=_list_bytes(s1a.bws, s1a.ns)
        + _touched_bytes(decode_stacked(s1a), s1b) + got.numel() * 4,
        max_abs_err=err,
        hits=int(got.sum()),
        shape=f"a {pa[0].n} docids in {pa[0].n_blocks} blocks, b "
              f"{pb[2].n} in {pb[2].n_blocks}")

    # -- scored_intersect_batched: the same rows with tf impacts --------
    # impacts min(tf, 255) drawn from the stream's head term's per-tweet
    # tf distribution, so block maxima differ and a threshold can split
    first = docs[: 1 << 20]
    head = int(np.bincount(first[first >= 0]).argmax())
    tfs = (first == head).sum(1)
    tfs = tfs[tfs > 0]

    def impacts(n):
        return np.minimum(rng.choice(tfs, n), SCORE_MAX).astype(np.int32)
    sca = stack_scored([attach_scores(p, impacts(p.n)) for p in pa]).to(dev)
    scb = stack_scored([attach_scores(p, impacts(p.n)) for p in pb]).to(dev)
    rows_n = sca.bmax.shape[0]
    rest = torch.as_tensor(rng.integers(0, 8, rows_n), dtype=torch.int32,
                           device=dev)
    bound = (sca.bmax.long() + rest.long()[:, None]).cpu().numpy()
    nreal = (-(-sca.ids.ns.cpu().numpy() // SEG_BLOCK)).astype(np.int64)
    ths = {"none": np.full(rows_n, -1),
           "half": np.array([_split_threshold(bound[r], nreal[r])
                             for r in range(rows_n)]),
           "all": bound.max(1) + 1}
    err, skipped, runs = 0, {}, {}
    for name, th in ths.items():
        th = torch.as_tensor(th, dtype=torch.int32, device=dev)
        got = ops.scored_intersect_batched(sca, scb, rest, th)
        want = ref.scored_intersect_batched_ref(sca, scb, rest, th)
        torch.cuda.synchronize()
        err = max(err, require_equal(f"scored_intersect_batched/{name}",
                                     got, want))
        live_blk = torch.as_tensor(bound, device=dev) > th.long()[:, None]
        skipped[name] = float(1 - (live_blk.cpu().numpy()[
            np.arange(bound.shape[1])[None, :] < nreal[:, None]]).mean())
        runs[name] = (th, live_blk, int((got > 0).sum()))
    th0, live0, hits0 = runs["none"]
    if not 0.2 <= skipped["half"] <= 0.8 or skipped["all"] != 1.0:
        raise AssertionError(f"scored thresholds skip {skipped}")
    a_ids, b_ids = decode_stacked(sca.ids), decode_stacked(scb.ids)
    a_sc, b_sc = decode_scores(sca.swords), decode_scores(scb.swords)

    def library():
        pos = torch.searchsorted(b_ids, a_ids).clamp_(max=b_ids.shape[1] - 1)
        hit = torch.gather(b_ids, 1, pos) == a_ids
        return torch.where(hit, a_sc + torch.gather(b_sc, 1, pos), 0)
    th_half = runs["half"][0]
    ms_half = cuda_ms(lambda: ops.scored_intersect_batched(sca, scb, rest,
                                                           th_half))
    rows["scored_intersect_batched"] = dict(
        ms=cuda_ms(lambda: ops.scored_intersect_batched(sca, scb, rest,
                                                        th0)),
        ms_half=ms_half,
        plain_ms=cuda_ms(lambda: ref.scored_intersect_batched_ref(
            sca, scb, rest, th0)),
        library_ms=cuda_ms(library),
        bytes=_scored_bytes(sca, scb, a_ids, live0), max_abs_err=err,
        hits=hits0,
        shape=f"N={rows_n} rows, NB={sca.ids.n_blocks} blocks, the "
              f"segment rows with impacts from term {head}'s tf "
              f"(max {int(tfs.max())}); th=-1 (main path); blocks "
              f"skipped at the three thresholds "
              f"{', '.join(f'{k} {v:.3f}' for k, v in skipped.items())}; "
              f"kernel at the half threshold {ms_half:.4f} ms")
    del sca, scb, a_ids, b_ids, a_sc, b_sc, runs
    torch.cuda.empty_cache()

    # -- intersect_mask: edge cases, then active lists at max_len -------
    n_edge = intersect_edge_cases()
    max_len = 1 << (seg_docs - 1).bit_length()
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    for name, a2, b2 in tim.full_width_shapes(la[0], lb[2], max_len, dev):
        want = ref.intersect_mask_ref(a2, b2)
        got, again = ops.intersect_mask(a2, b2), ops.intersect_mask(a2, b2)
        torch.cuda.synchronize()
        err = require_equal(f"intersect_mask/{name}", got, want)
        require_equal(f"intersect_mask/{name} repeat", again, want)

        def call(a2=a2, b2=b2):
            return ops.intersect_mask(a2, b2)

        def library(a2=a2, b2=b2):
            pos = torch.searchsorted(b2, a2).clamp_(max=max_len - 1)
            return torch.gather(b2, 0, pos) == a2
        needed, full = tim.bound_bytes(a2, b2)
        r = dict(ms=cuda_ms(call), ms_cold=cuda_ms_cold(call, flush),
                 device_ms=profiled_ms(call, "intersect_mask")[0],
                 plain_ms=cuda_ms(lambda a2=a2, b2=b2:
                                  ref.intersect_mask_ref(a2, b2)),
                 library_ms=cuda_ms(library), bytes=needed,
                 max_abs_err=err, hits=int(got.sum()),
                 shape=f"{name}: na=nb={max_len} "
                       f"({int((a2 != 0xFFFFFFFF).sum())} and "
                       f"{int((b2 != 0xFFFFFFFF).sum())} valid)")
        log(f"intersect_mask {r['shape']}: bit-identical twice; kernel "
            f"{r['ms']:.4f} ms warm, {r['ms_cold']:.4f} L2-flushed, "
            + ("profiler not measured" if r["device_ms"] is None else
               f"{r['device_ms']:.4f} by the profiler")
            + f"; library {r['library_ms']:.4f} ms; bound "
            f"{needed / HBM_BYTES_PER_S * 1e3:.4f} ms ({needed} bytes as "
            f"the call needs them; {full / HBM_BYTES_PER_S * 1e3:.4f} ms "
            f"over the padded arrays)")
        rows.setdefault("intersect_mask", r)    # the row: head vs torso
    log(f"intersect_mask: {n_edge} edge cases bit-identical twice")
    del flush

    for name, r in rows.items():
        r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"kernel {name}: {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bytes']} bytes), "
            f"bit-identical")
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------
def size_layout(docs: np.ndarray, vocab: int, seg_docs: int,
                headroom: float = 1.25):
    """Pools sized by the analytical model from the stream's own
    per-segment term frequencies (the larger of the first segment and
    the rest), with headroom, rounded up to powers of two."""
    need = np.zeros(len(Z), np.int64)
    fmax = 1
    for s in range(0, docs.shape[0], seg_docs):
        f = synth.term_freqs(docs[s: s + seg_docs], vocab)
        f = f[f > 0]
        fmax = max(fmax, int(f.max()))
        n_sl = analytical.slices_needed(Z, f)
        for p in range(len(Z)):
            # slice i of a chain lives in pool min(i, P-1)
            cnt = np.clip(n_sl - p, 0, None) if p == len(Z) - 1 else (
                n_sl > p).astype(np.int64)
            need[p] = max(need[p], int(cnt.sum()))
    cap = pointers.production_layout().max_slices
    spp = tuple(min(1 << int(np.ceil(np.log2(max(n * headroom, 2)))),
                    cap(p)) for p, n in enumerate(need))
    return pointers.production_layout(spp), need, fmax


def query_calls(eng, queries, pairs):
    """(kind, queries, batched call) of every query kind the engine
    serves."""
    return (("conjunctive", queries, eng.conjunctive_batch),
            ("disjunctive", queries, eng.disjunctive_batch),
            ("phrase", pairs, eng.phrase_batch),
            ("topk", queries,
             lambda qs: eng.topk_conjunctive_batch(qs, 10)),
            ("scored", queries,
             lambda qs: eng.scored_topk_batch(qs, SCORED_K)),
            ("scored_full", queries, eng.scored_full_batch))


def run_queries(eng, queries, pairs, q_rows: int):
    """Every kind in batches of ``q_rows``: {kind: (answers, ms per
    batch, peak device bytes while the kind ran)}."""
    out = {}
    for kind, batch, call in query_calls(eng, queries, pairs):
        res, times = [], []
        torch.cuda.reset_peak_memory_stats()
        for s in range(0, len(batch), q_rows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res += call(batch[s: s + q_rows])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[kind] = (res, times, torch.cuda.max_memory_allocated())
    return out


def device_profile(fn, warm: bool = False) -> dict:
    """One traced call of ``fn`` under the profiler: wall time (host
    clock around the synchronised call), device-busy time (the sum of
    the device's kernel and copy durations: one stream, so they do not
    overlap), the idle share, the device event count and the top device
    ops by time (name, ms, count), and every device op's (ms, count) by
    name (``per``).  With ``warm``, 64 one-element fills
    and ``fn`` first run once more inside the session and only device
    events that start after the traced call's start count: late in this
    script (phase 6, after the sessions of phases 3 and 5) a session was
    seen to drop its first 21 device events, and sometimes more (a
    6-event call lost all of its own after one warm call); the fills
    absorb them without a wrapper launch, so the launch counts stay."""
    from torch.profiler import ProfilerActivity, profile, record_function
    mark = "chip_smoke.traced_call"
    pad = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if warm:
            for _ in range(64):
                pad.zero_()
            fn()
            torch.cuda.synchronize()
        with record_function(mark):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    start = min(e.time_range.start for e in events if e.name == mark)
    # device-side events only (kernels and copies; not the marker's own
    # device range): the CPU-side operator events carry their kernels'
    # time too
    per = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                e.name != mark and (not warm or e.time_range.start >= start):
            t, c = per.get(e.name, (0.0, 0))
            per[e.name] = (t + e.device_time_total / 1e3, c + 1)
    busy = sum(t for t, _ in per.values())
    top = sorted(((k[:60], t, c) for k, (t, c) in per.items()),
                 key=lambda x: -x[1])[:6]
    return dict(out=out, wall_ms=wall, busy_ms=busy, idle=1 - busy / wall,
                events=sum(c for _, c in per.values()), top=top, per=per)


def top_ops(prof: dict, digits: int = 1) -> str:
    return "; ".join(f"{k} {t:.{digits}f} ms x{c}" for k, t, c in prof["top"])


def profile_paths(eng, docs, queries, pairs, q_rows: int) -> None:
    """One traced ingest batch and one traced query batch of each kind
    (:func:`device_profile`).  Runs after the measured main path, whose
    launch counts it leaves alone."""
    calls = [("ingest", lambda: eng.ingest(docs))] + [
        (kind, lambda c=call, b=batch: c(b[:q_rows])) for kind, batch, call
        in query_calls(eng, queries, pairs)]
    for name, fn in calls:
        p = device_profile(fn)
        log(f"profile {name}: wall {p['wall_ms']:.1f} ms, device busy "
            f"{p['busy_ms']:.1f} ms ({100 * p['idle']:.0f}% idle); top: "
            + top_ops(p))
        if name == "ingest":
            # the scatter kernel where it runs: the plan has just written
            # its streams, so they may still be in the L2
            ba = [(t, c) for k, (t, c) in p["per"].items()
                  if "bulk_append" in k]
            ms, n = sum(t for t, _ in ba), sum(c for _, c in ba)
            log(f"profile ingest: bulk_append_kernel {ms:.4f} ms over {n} "
                f"launch(es) in the traced batch"
                + (f" ({ms / n:.4f} ms each)" if n else ""))


def oracle_answers(bf: BruteForce, queries, pairs):
    conj = [bf.conjunctive(q) for q in queries]
    scored = [bf.scored(q) for q in queries]
    return {"conjunctive": conj,
            "disjunctive": [bf.disjunctive(q) for q in queries],
            "phrase": [bf.phrase(*p) for p in pairs],
            "topk": [c[:10] for c in conj],
            "scored": [(i[:SCORED_K], s[:SCORED_K]) for i, s in scored],
            "scored_full": scored}


def phase_main(docs: np.ndarray, layout, vocab: int, seg_docs: int,
               extra_docs: int, q_rows: int, n_queries: int, fmax: int):
    max_len = 1 << int(fmax - 1).bit_length()
    max_slices = int(analytical.slices_needed(Z, fmax)) + 1
    log(f"main path: max_len {max_len}, max_slices {max_slices}, "
        f"query rows per batch {q_rows}")
    torch.cuda.reset_peak_memory_stats()
    eng = LifecycleEngine(layout, vocab, seg_docs, max_slices=max_slices,
                          max_len=max_len, device="cuda")
    ops.reset_launch_counts()
    total = seg_docs + extra_docs
    t_first = t_roll = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, total, BATCH):
        if s == seg_docs - BATCH:
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t0
        eng.ingest(docs[s: s + BATCH])
        if s == seg_docs - BATCH:
            torch.cuda.synchronize()
            t_roll = time.perf_counter() - t0 - t_first
            hw_slots = eng.stats.high_water_slots
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    eng.check_health()
    if eng.stats.rollovers != 1:
        raise AssertionError(f"expected one rollover, saw "
                             f"{eng.stats.rollovers}")
    t_after = t_all - t_first - t_roll
    hw_after = eng.memory_high_water_slots()
    log(f"ingest: {seg_docs - BATCH} docs in {t_first:.3f} s = "
        f"{(seg_docs - BATCH) / t_first:.0f} docs/s; the batch that "
        f"filled the segment + rollover (freeze, reclaim) "
        f"{t_roll:.3f} s; {extra_docs} docs into recycled slices in "
        f"{t_after:.3f} s = {extra_docs / t_after:.0f} docs/s")
    log(f"pools: high-water {hw_slots} slots at rollover, {hw_after} after "
        f"{extra_docs} more docs (bounded by reclamation); live "
        f"{eng.memory_slots_used()}")
    queries, pairs = query_batch(docs[:total], vocab, n_queries, seed=1)
    ingest_peak = torch.cuda.max_memory_allocated()
    res = run_queries(eng, queries, pairs, q_rows)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = max([ingest_peak] + [r[2] for r in res.values()])
    for kind, (_, times, kpeak) in res.items():
        log(f"query {kind}: {len(times)} batches of {q_rows}: "
            f"{', '.join(f'{t:.1f}' for t in times)} ms; median "
            f"{np.median(times):.1f} ms; peak device memory "
            f"{kpeak / 2**30:.2f} GiB")
    skip = (eng.stats.scored_blocks_skipped, eng.stats.scored_blocks_live)
    log(f"scored top-k (k={SCORED_K}): {skip[0]} of {skip[1]} live "
        f"driving-term blocks skipped ({skip[0] / max(skip[1], 1):.3f})")
    log(f"main-path launches: {json.dumps(counts)}; peak device memory "
        f"{peak / 2**30:.2f} GiB ({peak} bytes; ingest "
        f"{ingest_peak / 2**30:.2f} GiB)")
    for k in ("bulk_append", "segment_intersect_mask_batched",
              "scored_intersect_batched"):
        if counts[k] <= 0:
            raise AssertionError(f"main path never launched {k}")
    profile_paths(eng, docs[total: total + BATCH], queries, pairs, q_rows)
    bf = BruteForce(docs[:total], {t for q in queries for t in q}, vocab)
    want = oracle_answers(bf, queries, pairs)
    for kind, (got, _, _) in res.items():
        check_answers(kind, got, want[kind])
    log(f"brute force: {n_queries} queries of each kind agree "
        f"(conjunctive hits {sum(len(x) for x in want['conjunctive'])}, "
        f"disjunctive {sum(len(x) for x in want['disjunctive'])}, phrase "
        f"{sum(len(x) for x in want['phrase'])}, scored "
        f"{sum(len(i) for i, _ in want['scored_full'])})")
    summary = dict(
        ingest_docs_per_s=(seg_docs - BATCH) / t_first,
        recycled_docs_per_s=extra_docs / t_after, rollover_s=t_roll,
        query_ms={k: float(np.median(v[1])) for k, v in res.items()},
        query_peak_bytes={k: v[2] for k, v in res.items()},
        scored_blocks_skipped=skip[0], scored_blocks_live=skip[1],
        high_water_slots=hw_after, peak_bytes=peak, launches=counts)
    del eng
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# phase 4: compaction and the sequential route, smaller depth
# ---------------------------------------------------------------------------
def phase_sequential(docs: np.ndarray, vocab: int, seg_docs: int,
                     n_queries: int, tmp: str, save_calls: str = ""):
    """``tmp``: a scratch directory for the snapshot and the journal;
    ``save_calls``: where to ``torch.save`` the sequential route's
    ``intersect_mask`` inputs (CPU (a, b) pairs, in order), if given."""
    n_docs = docs.shape[0]
    layout, _, fmax = size_layout(docs, vocab, seg_docs)
    eng = LifecycleEngine(
        layout, vocab, seg_docs,
        max_slices=int(analytical.slices_needed(Z, fmax)) + 1,
        max_len=1 << int(fmax - 1).bit_length(),
        compaction=CompactionPolicy(fanout=2), device="cuda")
    snap = os.path.join(tmp, "engine.snap")
    jrnl = os.path.join(tmp, "ingest.jrnl")
    starts = range(0, n_docs, BATCH)
    snap_at = len(starts) // 2
    with recovery.IngestJournal(jrnl) as journal:
        for i, s in enumerate(starts):
            if i == snap_at:
                recovery.snapshot(eng, snap, seq=i)
            journal.append(docs[s: s + BATCH])      # journal, then apply
            eng.ingest(docs[s: s + BATCH])
    eng.check_health()
    fp = recovery.engine_fingerprint(eng)   # before scored queries
    tiers = [fz.tier for fz in eng.segments.frozen]
    if eng.stats.rollovers < 3 or eng.stats.compactions < 1:
        raise AssertionError(f"rollovers {eng.stats.rollovers}, "
                             f"compactions {eng.stats.compactions}")
    queries, pairs = query_batch(docs, vocab, n_queries, seed=2)
    batched = run_queries(eng, queries, pairs, n_queries)
    eng.batched = False
    calls, real = [], ops.intersect_mask

    def spy(a, b):              # keeps the call's inputs; launches once
        calls.append((a.clone(), b.clone()))
        return real(a, b)
    ops.intersect_mask = spy
    ops.reset_launch_counts()
    try:
        seq = run_queries(eng, queries, pairs, n_queries)
    finally:
        ops.intersect_mask = real
    counts = ops.launch_counts()
    if len(calls) != counts["intersect_mask"]:
        raise AssertionError(f"{len(calls)} intersect_mask calls seen, "
                             f"{counts['intersect_mask']} launches counted")
    def replay():
        for a, b in calls:
            ops.intersect_mask(a, b)
    seq_ms, seen = profiled_total_ms(replay, "intersect_mask")
    need = sum(tim.bound_bytes(a, b)[0] for a, b in calls)
    log(f"sequential route: {len(calls)} intersect_mask calls at their own "
        f"shapes (na {sorted({a.shape[-1] for a, _ in calls})}), replayed "
        f"under the profiler: {seen} kernels, {seq_ms:.4f} ms in all "
        f"({seq_ms / max(seen, 1):.4f} ms each); their bound "
        f"{need / HBM_BYTES_PER_S * 1e3:.4f} ms ({need} bytes)")
    if save_calls:
        torch.save([(a.cpu(), b.cpu()) for a, b in calls], save_calls)
        log(f"sequential route: {len(calls)} intersect_mask inputs saved "
            f"to {save_calls}")
    del calls
    bf = BruteForce(docs, {t for q in queries for t in q}, vocab)
    want = oracle_answers(bf, queries, pairs)
    for kind in batched:
        check_answers(f"{kind} batched", batched[kind][0], want[kind])
        check_answers(f"{kind} sequential", seq[kind][0], want[kind])
    log(f"sequential phase: {eng.stats.rollovers} rollovers, "
        f"{eng.stats.compactions} compactions, frozen tiers {tiers}; "
        f"{n_queries} queries of each kind batched == sequential == brute "
        f"force; sequential-route launches {json.dumps(counts)}")
    for k in ("intersect_mask", "segment_intersect_mask"):
        if counts[k] <= 0:
            raise AssertionError(f"sequential route never launched {k}")
    del eng
    torch.cuda.empty_cache()

    # -- durability: the engine is gone; recover it on the card --------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = recovery.recover(snap, jrnl, expect_seq=len(starts),
                           device="cuda")
    torch.cuda.synchronize()
    t_rec = time.perf_counter() - t0
    if recovery.engine_fingerprint(rec) != fp:
        raise AssertionError("recovered engine's fingerprint differs from "
                             "the uncrashed engine's")
    got = run_queries(rec, queries, pairs, n_queries)
    for kind in got:
        check_answers(f"{kind} recovered", got[kind][0], batched[kind][0])
    with open(snap, "rb") as f:
        blob = f.read()
    cut = os.path.join(tmp, "truncated.snap")
    with open(cut, "wb") as f:
        f.write(blob[: len(blob) * 2 // 5])
    try:
        recovery.restore(cut, device="cuda")
    except recovery.CorruptSnapshotError:
        pass
    else:
        raise AssertionError("a truncated archive restored")
    log(f"durability: snapshot at batch {snap_at} of {len(starts)} "
        f"({len(blob)} bytes), journal replay of {len(starts) - snap_at} "
        f"batches: recovered on the card in {t_rec:.2f} s with an equal "
        f"fingerprint and equal answers of every kind; a truncated "
        f"archive raises CorruptSnapshotError")
    del rec
    torch.cuda.empty_cache()
    return counts

# ---------------------------------------------------------------------------
# phase 5: paged-KV decoder serving at TinyLlama-1.1B full width
# ---------------------------------------------------------------------------
PAGED_Z = (6, 8, 10)          # Z_kv: 64 / 256 / 1024-token slices
PAGED_ERR = 1e-4              # kernel vs plain version, fp32 output
DENSE_ERR = 1e-3              # paged vs dense logits, fp32 at full width
LM_HEAD_ARCHS = ("tinyllama-1.1b", "gemma3-12b", "deepseek-coder-33b",
                 "qwen2-moe-a2.7b", "grok-1-314b")   # G 8/2/7/1/6, D 64-256


def _paged_case(rng, B, Hkv, G, D, lens, heap_pages, NP, dtype):
    """Kernel inputs at serving shapes: distinct random pages of a full
    heap per row (``NP`` columns, -1 pads past each row's length)."""
    dev = torch.device("cuda")
    table = rng.permutation(heap_pages)[:B * NP].reshape(B, NP)
    need = np.minimum(-(-np.asarray(lens) // kv.PAGE), NP)
    table = np.where(np.arange(NP)[None, :] < need[:, None], table, -1)
    q = torch.randn(B, Hkv, G, D, device=dev).to(dtype)
    kh = torch.randn(Hkv, heap_pages * kv.PAGE, D, device=dev).to(dtype)
    vh = torch.randn_like(kh)
    return (q, kh, vh, torch.as_tensor(table, dtype=torch.int32, device=dev),
            torch.as_tensor(lens, dtype=torch.int32, device=dev))


def _paged_bytes(q, kh, table, lens) -> int:
    """Bytes the kernel must move: the K and V pages each row walks
    (min(ceil(len / 64), NP) pages, read once), q, the table, the lengths
    and the fp32 output."""
    B, Hkv, G, D = q.shape
    pages = torch.clamp(-(-lens.long() // kv.PAGE), max=table.shape[1])
    kv_bytes = int(pages.sum()) * kv.PAGE * D * kh.element_size() * 2 * Hkv
    return (kv_bytes + q.numel() * q.element_size() + table.numel() * 4
            + lens.numel() * 4 + q.numel() * 4)


def _paged_check(name, args) -> float:
    """The kernel against its plain version within ``PAGED_ERR``, and a
    second call on the same inputs bit-equal to the first (the split
    partials merge in split order; the tickets reset)."""
    got = ops.paged_attention(*args)
    again = ops.paged_attention(*args)
    torch.cuda.synchronize()
    want = ref.paged_attention_ref(*args)
    err = float((got - want).abs().max())
    if not torch.isfinite(got).all() or err > PAGED_ERR:
        raise AssertionError(f"paged_attention/{name}: max abs err {err} "
                             f"against its plain version (limit "
                             f"{PAGED_ERR})")
    if not torch.equal(got, again):
        raise AssertionError(f"paged_attention/{name}: two calls on the "
                             f"same inputs differ")
    return err


def _paged_split(B, Hkv, G, NP) -> str:
    """The split the wrapper picks at this shape (``split_plan``)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    S, pps = pa_kernel.split_plan(B, Hkv, G, NP, sms)
    return (f"{S} splits x {pps} pages, "
            f"{B * Hkv * -(-G // pa_kernel.HEADS) * S} CTAs on {sms} SMs")


def _paged_times(name, args, flush) -> dict:
    """The kernel and the library yardstick at one shape, warm (mean of
    20 back-to-back launches) and cold (each launch timed alone after
    the L2 is overwritten, as a serving step finds the pages), beside
    the byte bound; logs the split the wrapper chose."""
    nbytes = _paged_bytes(args[0], args[1], args[3], args[4])
    t = dict(ms=cuda_ms(lambda: ops.paged_attention(*args), reps=20),
             ms_cold=cuda_ms_cold(lambda: ops.paged_attention(*args), flush,
                                  reps=20),
             library_ms=cuda_ms(lambda: _sdpa_library(*args), reps=20),
             library_ms_cold=cuda_ms_cold(lambda: _sdpa_library(*args),
                                          flush),
             bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
             split=_paged_split(*args[0].shape[:3], args[3].shape[1]))
    log(f"paged_attention {name} ({t['split']}): kernel {t['ms']:.4f} ms "
        f"warm, {t['ms_cold']:.4f} ms L2-flushed; library (gather + sdpa) "
        f"{t['library_ms']:.4f} / {t['library_ms_cold']:.4f} ms; bound "
        f"{t['bound_ms']:.4f} ms ({nbytes} bytes)")
    return t


def _sdpa_library(q, kh, vh, table, lens):
    """The library yardstick: page gather, then one
    ``scaled_dot_product_attention`` with a length mask and GQA."""
    B, Hkv, G, D = q.shape
    slots = (table.long().clamp(min=0)[:, :, None] * kv.PAGE
             + torch.arange(kv.PAGE, device=q.device)).reshape(B, -1)
    k = kh[:, slots].permute(1, 0, 2, 3)
    v = vh[:, slots].permute(1, 0, 2, 3)
    mask = (torch.arange(slots.shape[1], device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(
        q.reshape(B, Hkv * G, 1, D), k, v, attn_mask=mask, enable_gqa=True)


def paged_kernel_row(cfg, layout, max_seqs: int, max_len: int, seed: int,
                     flush):
    """The kernel against its plain version (fp32 and bf16): at the
    serving shapes with edge lengths, at B = 1 (a prefill call) across
    the split edges, at every registry LM head shape on a small heap;
    and its times at full length in bf16, at B = max_seqs and B = 1."""
    rng = np.random.default_rng(seed)
    B, Hkv, D = max_seqs, cfg.n_kv_heads, cfg.d_head
    G = cfg.n_heads // Hkv
    NP = -(-max_len // kv.PAGE)
    heap_pages = layout.total_slots // kv.PAGE
    edge = [0, 1, 63, 64, 65, 1000, max_len - 1, max_len, max_len + 100]
    lens = (edge + list(rng.integers(1, max_len + 1, B)))[:B]
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        args = _paged_case(rng, B, Hkv, G, D, lens, heap_pages, NP, dt)
        errs[name] = _paged_check(f"edge/{dt}", args)
        for n in (1, 64, 65, max_len - 1, max_len, max_len + 100):
            args = _paged_case(rng, 1, Hkv, G, D, [n], heap_pages, NP, dt)
            errs[f"{name}_b1"] = max(errs.get(f"{name}_b1", 0.0),
                                     _paged_check(f"B=1 len {n}/{dt}", args))
        for arch in LM_HEAD_ARCHS:
            c = registry.get(arch).config
            hk, g = c.n_kv_heads, c.n_heads // c.n_kv_heads
            small = rng.integers(0, 8 * kv.PAGE + 30, 8).tolist()
            args = _paged_case(rng, 8, hk, g, c.d_head, small, 8 * 8 + 8, 8,
                               dt)
            errs[f"{name}_heads"] = max(errs.get(f"{name}_heads", 0.0),
                                        _paged_check(f"{arch}/{dt}", args))
    log(f"paged_attention checks: split at the serving shape "
        f"{_paged_split(B, Hkv, G, NP)}, at B = 1 "
        f"{_paged_split(1, Hkv, G, NP)}; head shapes {LM_HEAD_ARCHS} on "
        f"8 rows of 8 pages; max abs err {errs}")
    args = _paged_case(rng, B, Hkv, G, D, [max_len] * B, heap_pages, NP,
                       torch.bfloat16)
    errs["bf16_full"] = _paged_check("full/bf16", args)
    full = _paged_times(f"B={B} x {max_len} tokens", args, flush)
    row = dict(ms=full["ms"], ms_cold=full["ms_cold"],
               plain_ms=cuda_ms(lambda: ref.paged_attention_ref(*args)),
               library_ms=full["library_ms"], bytes=full["bytes"],
               bound_ms=full["bound_ms"], max_abs_err=max(errs.values()),
               times={"full": full})
    args = _paged_case(rng, 1, Hkv, G, D, [max_len], heap_pages, NP,
                       torch.bfloat16)
    errs["bf16_b1_full"] = _paged_check("B=1 full/bf16", args)
    row["times"]["b1"] = _paged_times(f"B=1 x {max_len} tokens", args, flush)
    log(f"kernel paged_attention: B={B}, Hkv={Hkv}, G={G}, D={D}, {NP} "
        f"pages of {kv.PAGE} per row, all rows at {max_len} tokens, bf16 "
        f"heaps of {layout.total_slots} slots: kernel {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, library (gather + sdpa) "
        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bytes']} bytes)")
    return row


def paged_vs_dense(cfg, params, n_seqs: int, steps: int, seed: int):
    """The paged decode against the dense decode in fp32 at full width:
    ``n_seqs`` sequences in lockstep, each fed its own greedy token."""
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    def cast(tree):
        return {k: cast(v) if isinstance(v, dict) else v.float()
                for k, v in tree.items()}
    p32 = cast(params)     # the same weights, widened
    layout = paged_serve.kv_layout(PAGED_Z, n_seqs, steps)
    server = sm.make_server(cfg32, layout, n_seqs, steps, "cuda")
    state = kv.init_kv_state(server.kv_cfg, "cuda")
    cache = lm.init_decode_cache(cfg32, n_seqs, steps + 1, device="cuda")
    dev = torch.device("cuda")
    ids = torch.arange(n_seqs, device=dev)
    rng = np.random.default_rng(seed)
    tok = torch.as_tensor(rng.integers(1, cfg.vocab, n_seqs), device=dev)
    err = 0.0
    for t in range(steps):
        nxt, logits, state = sm.decode_step(server, p32, state, ids, tok)
        dense, cache = lm.lm_decode_step(p32, cache, tok[:, None], t, cfg32)
        if not torch.isfinite(logits).all():
            raise AssertionError(f"paged decode step {t}: non-finite logits")
        err = max(err, float((logits - dense).abs().max()))
        if not torch.equal(nxt.long(), dense.argmax(-1)):
            raise AssertionError(f"paged vs dense step {t}: greedy tokens "
                                 f"differ")
        tok = nxt.long()
    if err > DENSE_ERR or bool(state.overflow):
        raise AssertionError(f"paged vs dense: logits max abs err {err} "
                             f"(limit {DENSE_ERR}), overflow "
                             f"{bool(state.overflow)}")
    log(f"paged vs dense (fp32, TF32 off): {n_seqs} sequences x {steps} "
        f"steps, logits max abs err {err:.3g}, every greedy token equal; "
        f"final lengths {state.length.tolist()}")
    del p32, state, cache
    torch.cuda.empty_cache()
    return err


def traced_decode_step(server, params, state) -> dict:
    """One decode step of every slot under the profiler: wall time and
    device-busy time (kernels and copies on the one stream)."""
    dev = server.device
    ids = torch.arange(server.kv_cfg.max_seqs, device=dev)
    tok = torch.ones_like(ids)
    p = device_profile(lambda: sm.decode_step(server, params, state, ids,
                                              tok), warm=True)
    if not torch.isfinite(p["out"][1]).all():
        raise AssertionError("traced decode step: non-finite logits")
    log(f"profile paged decode step (B={len(ids)}): wall {p['wall_ms']:.2f} "
        f"ms, device busy {p['busy_ms']:.2f} ms ({100 * p['idle']:.0f}% "
        f"idle), {p['events']} device events; top: " + top_ops(p, 3))
    return dict(wall_ms=p["wall_ms"], busy_ms=p["busy_ms"], idle=p["idle"])


def phase_paged(seed: int, requests: int = 64, max_seqs: int = 32,
                max_len: int = 2048):
    torch.manual_seed(seed)        # the kernel checks' random inputs
    cfg = registry.get("tinyllama-1.1b").config
    layout = paged_serve.kv_layout(PAGED_Z, max_seqs, max_len)
    heap_bytes = (2 * cfg.n_layers * cfg.n_kv_heads * layout.total_slots
                  * cfg.d_head * 2)
    log(f"paged serving: {cfg.name}, {cfg.param_count} parameters, "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.d_head}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}; Z_kv {PAGED_Z}, pools {layout.slices_per_pool} "
        f"slices ({layout.total_slots} token slots, KV heap "
        f"{heap_bytes / 2**30:.2f} GiB in bf16)")
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    log(f"weights: random bf16 from seed {seed} in "
        f"{time.perf_counter() - t0:.1f} s")
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    row = paged_kernel_row(cfg, layout, max_seqs, max_len, seed, flush)
    del flush                      # out of the serving run's peak memory
    row["dense_err"] = paged_vs_dense(cfg, params, 4, 80, seed)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    stats, server, state = paged_serve.serve(
        cfg, params, layout, requests=requests, max_seqs=max_seqs,
        max_len=max_len, seed=seed, device="cuda", log=log)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    calls = stats["decode_steps"] + stats["prefill_tokens"]
    if counts["paged_attention"] != cfg.n_layers * calls:
        raise AssertionError(f"paged_attention launched "
                             f"{counts['paged_attention']} times for "
                             f"{calls} decode_step calls")
    toks = np.concatenate([np.asarray(g) for g in
                           stats["generated"].values()])
    if len(stats["generated"]) != requests or toks.min() < 0 or \
            toks.max() >= cfg.vocab:
        raise AssertionError("serving produced a request without tokens "
                             "or a token outside the vocabulary")
    log(f"paged serving: prefill {stats['prefill_tokens']} tokens at "
        f"{stats['prefill_tok_per_s']:.1f} tok/s, decode "
        f"{stats['decode_tokens']} tokens in {stats['decode_steps']} steps "
        f"at {stats['decode_tok_per_s']:.1f} tok/s ({stats['ms_per_step']:.2f}"
        f" ms per step, median {stats['median_ms_per_step']:.2f}); overall "
        f"{stats['tok_per_s']:.1f} tok/s over {stats['seconds']:.1f} s")
    log(f"paged serving: C_M waste {stats['cm_waste']:.4f} (alloc "
        f"{stats['alloc_slots']} vs used {stats['used_slots']} slots), mean "
        f"chain hops {stats['mean_hops']:.3f}; {stats['outgrew_max_len']} "
        f"slots outgrew max_len {max_len}; overflow {stats['overflow']}; "
        f"watermark {stats['watermark']}; launches {json.dumps(counts)}; "
        f"peak device memory {peak / 2**30:.2f} GiB ({peak} bytes)")

    # the kernel against its plain version on the final serving state
    ids = torch.arange(max_seqs, device="cuda")
    table = server.tables(state, ids)
    lens = state.length[ids]
    q = torch.randn(max_seqs, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                    cfg.d_head, device="cuda").to(torch.bfloat16)
    fin = {}
    for layer in (0, cfg.n_layers - 1):
        args = (q, state.k_heap[layer], state.v_heap[layer], table, lens)
        fin[layer] = _paged_check(f"final state layer {layer}", args)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    real = _paged_times(f"on the final serving state (lengths "
                        f"{lens.tolist()})", args, flush)
    del flush
    row["times"]["final_state"] = real
    row["max_abs_err"] = max(row["max_abs_err"], *fin.values())
    log(f"paged_attention on the final serving state: max abs err {fin}")
    prof = traced_decode_step(server, params, state)
    summary = dict(stats={k: v for k, v in stats.items()
                          if k not in ("generated", "lengths")},
                   peak_bytes=peak, kernel_times=row["times"], profile=prof,
                   dense_err=row["dense_err"])
    del params, state, server
    torch.cuda.empty_cache()
    return row, counts, summary


def phase_small(save_calls: str = "") -> dict:
    """Phase 4 at its 2**16-tweet depth (the same whatever
    ``--segment-log2``); returns the sequential route's launches."""
    small = 1 << 16
    sdocs = make_stream(1 << 16, 4 * small + small // 2, seed=7)
    with tempfile.TemporaryDirectory() as tmp:
        return phase_sequential(sdocs, 1 << 16, small, n_queries=16,
                                tmp=tmp, save_calls=save_calls)


def phase_index(segment_log2: int):
    """Phases 2-4 (the streaming index); returns their kernel rows."""
    seg_docs = 1 << segment_log2
    vocab = 1 << (segment_log2 - 3)
    extra = seg_docs // 8
    t0 = time.perf_counter()
    # one more batch than the main path ingests: the traced ingest batch
    docs = make_stream(vocab, seg_docs + extra + BATCH, seed=0)
    layout, need, fmax = size_layout(docs, vocab, seg_docs)
    log(f"stream: {docs.shape[0]} tweets, vocab {vocab}, "
        f"{int((docs >= 0).sum())} postings, head-term segment freq "
        f"{fmax}; pools {layout.slices_per_pool} slices for an analytic "
        f"need of {tuple(int(x) for x in need)} ({layout.total_slots} "
        f"slots); made in {time.perf_counter() - t0:.1f} s")

    q_rows = 8
    kernels = phase_kernels(docs, layout, vocab, seg_docs, q_rows, seed=5)
    main_sum = phase_main(docs, layout, vocab, seg_docs, extra, q_rows,
                          n_queries=64, fmax=fmax)
    del docs
    seq_counts = phase_small()

    table = []
    for name in ("bulk_append", "segment_intersect_mask_batched",
                 "intersect_mask", "segment_intersect_mask",
                 "scored_intersect_batched"):
        r = kernels[name]
        on_main = name in ("bulk_append", "segment_intersect_mask_batched",
                           "scored_intersect_batched")
        table.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name],
            launches=(main_sum["launches"] if on_main
                      else seq_counts)[name],
            path="main" if on_main else "sequential",
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by="bytes",
            library_ms=r["library_ms"]))
    log("main path: " + json.dumps({
        k: v for k, v in main_sum.items() if k != "launches"}))
    return table


# ---------------------------------------------------------------------------
# phase 6: recsys serving (DCN-v2 at full width, xDeepFM, DIEN, DLRM)
# ---------------------------------------------------------------------------
# (arch, shapes, config changes): DCN-v2 exactly as published; xDeepFM
# and DIEN at serve_p99 only (their serve_bulk is a cut: xDeepFM's CIN
# tensor [262144, 200, 39, 10] alone is 82 GB); DLRM-MLPerf at its
# published widths with a bf16 table (the fp32 table, 89.5 GiB, does not
# fit one card: a cut)
RECSYS_CELLS = (
    ("dcn-v2", ("serve_p99", "serve_bulk", "retrieval_cand"), {}),
    ("xdeepfm", ("serve_p99",), {}),
    ("dien", ("serve_p99",), {}),
    ("dlrm-mlperf", ("serve_p99",), {"param_dtype": "bfloat16"}),
)
# embedding_bag calls per forward (models/recsys.py): DLRM and DCN-v2 one
# lookup; xDeepFM the lookup and the linear term's sum-bags; DIEN the
# target lookup, the history lookup and the history mean-bags; a
# retrieval step the user's mean-bag and the candidates
LOOKUPS = {"dot": 1, "cross": 1, "cin": 2, "augru": 3, "retrieval": 2}
BAG_ERR = 1e-5        # multi-row bags vs plain: max |diff| / max |plain|
FWD_ERR = 1e-4        # logits, kernel vs plain lookups: max |diff| /
                      # max(1e-3, max |logit|) (only the multi-row bags
                      # sum in another order)
SMALL_TOL = dict(rtol=1e-4, atol=1e-6)   # reduced configs, card vs CPU
TIMED, WARM = 10, 2   # batches per cell: 2 warm-ups, then 10 timed


@contextlib.contextmanager
def bags_through(fn):
    """Route every ``ops.embedding_bag`` call of the models to ``fn`` for
    the duration (the plain-lookup twin and the input capture; never
    used by the package itself)."""
    real = ops.embedding_bag
    ops.embedding_bag = fn
    try:
        yield real
    finally:
        ops.embedding_bag = real


def recsys_batch(cfg, spec, rng, dev="cuda") -> dict:
    """Uniform ids per field, normal dense features, DIEN histories with
    hist_len in [1, T) (tests/test_arch_smoke.py's batches); a retrieval
    batch is one user and uniform candidate rows of the table."""
    if spec.kind == "retrieval":
        n = spec.extra("n_candidates")
        user = np.stack([rng.integers(0, v, 1) for v in cfg.vocab_sizes], 1)
        return {"user_sparse": torch.as_tensor(user, dtype=torch.int32,
                                               device=dev),
                "cand_ids": torch.as_tensor(
                    rng.integers(0, cfg.total_rows, n), dtype=torch.int32,
                    device=dev)}
    B = spec.global_batch
    sparse = np.stack([rng.integers(0, v, B, dtype=np.int32)
                       for v in cfg.vocab_sizes], 1)
    batch = {"sparse": torch.as_tensor(sparse, device=dev)}
    if cfg.n_dense:
        batch["dense"] = torch.as_tensor(
            rng.standard_normal((B, cfg.n_dense), dtype=np.float32),
            device=dev)
    if cfg.interaction == "augru":
        T = cfg.seq_len
        hist = np.stack([rng.integers(0, cfg.vocab_sizes[0], (B, T)),
                         rng.integers(0, cfg.vocab_sizes[1], (B, T))], -1)
        batch["hist"] = torch.as_tensor(hist, dtype=torch.int32, device=dev)
        batch["hist_len"] = torch.as_tensor(rng.integers(1, T, B),
                                            dtype=torch.int32, device=dev)
    return batch


def serve_call(cfg, spec, params, batch, dev="cuda"):
    """(the cell's entry-point call, embedding_bag calls per call)."""
    if spec.kind == "retrieval":
        step = rsteps.make_recsys_retrieval_step(cfg, dev)
        return (lambda: step(params, batch["user_sparse"],
                             batch["cand_ids"]), LOOKUPS["retrieval"])
    fwd = rsteps.make_recsys_forward(cfg, dev)
    return lambda: fwd(params, batch), LOOKUPS[cfg.interaction]


def check_bag(name, got, table, idx, off, mode, plain=True) -> float:
    """The kernel's output on one call's inputs: bit-identical to the
    in-order sum (``in_order_bags``: each bag from its first row, one
    row at a time, the parent design's order) on every bag; and against
    the plain version, bags of one row bit-identical (to the plain
    version and to the table's rows), the others within ``BAG_ERR``
    (normwise relative).  ``plain=False`` skips the plain version (a
    malformed CSR: it assumes nondecreasing offsets, the kernel clamps
    each bag's own).  Returns the max absolute difference from the
    plain version."""
    order = tbag.in_order_bags(table, idx, off, mode)
    if got.dtype != torch.float32 or got.shape != order.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} "
                             f"against {tuple(order.shape)}")
    if not torch.equal(got, order):
        bad = int((got != order).any(1).sum())
        raise AssertionError(f"{name}: {bad} bags differ from the in-order "
                             f"sum")
    if not plain:
        return 0.0
    want = ref.embedding_bag_ref(table, idx, off, mode)
    lo, hi = tbag.bag_bounds(off, idx.numel())
    one = (hi - lo) == 1
    if not torch.equal(got[one], want[one]):
        raise AssertionError(f"{name}: a single-row bag differs from the "
                             f"plain version")
    if bool(one.all()) and one.numel():
        rows = table[idx.long()[lo].clamp(0, table.shape[0] - 1)].float()
        if not torch.equal(got, rows):
            raise AssertionError(f"{name}: single-row bags are not the "
                                 f"table's rows bit for bit")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    if not torch.isfinite(got).all() or err > BAG_ERR * max(scale, 1e-30):
        raise AssertionError(f"{name}: max abs err {err} against the plain "
                             f"version (limit {BAG_ERR} x {scale})")
    return err


def synthetic_bags(seed: int) -> float:
    """Check (b): the kernel against its plain version and the in-order
    sum on synthetic CSR bags: lengths 0-64, all-empty bags and N = 0,
    sum and mean, fp32 and bf16 tables at D in {1, 10, 16, 18, 128}, ids
    out of range (clip); then ``tbag.edge_cases`` (bags longer than a
    chunk, bags straddling its tiles, ``offsets[0] > 0``, a malformed
    CSR, table views at odd rows and elements) and the ten path shapes
    at a 100,000-row table (``tbag.path_shapes``), each called twice and
    bit-equal."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    err, cases = 0.0, 0
    for D in (1, 10, 16, 18, 128):
        for dt in (torch.float32, torch.bfloat16):
            R = 100_000
            table = torch.randn(R, D, device=dev).to(dt)
            lens_sets = (np.r_[0, 64, rng.integers(0, 65, 4000)],
                         np.zeros(7, np.int64), np.zeros(0, np.int64),
                         np.ones(5000, np.int64))
            for lens in lens_sets:
                off = np.zeros(len(lens) + 1, np.int32)
                off[1:] = np.cumsum(lens)
                idx = torch.as_tensor(rng.integers(-100, R + 100, off[-1]),
                                      dtype=torch.int32, device=dev)
                off = torch.as_tensor(off, device=dev)
                for mode in ("sum", "mean"):
                    got = ops.embedding_bag(table, idx, off, mode)
                    torch.cuda.synchronize()
                    err = max(err, check_bag(
                        f"synthetic D={D} {dt} {len(lens)} bags {mode}",
                        got, table, idx, off, mode))
                    cases += 1
    more = (tbag.edge_cases(seed=seed) + tbag.path_shapes(seed=seed))
    for name, table, idx, off, mode in more:
        got = ops.embedding_bag(table, idx, off, mode)
        again = ops.embedding_bag(table, idx, off, mode)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{name} {mode}: two calls differ")
        err = max(err, check_bag(f"{name} {mode}", got, table, idx, off,
                                 mode, plain="malformed" not in name))
    log(f"embedding_bag vs plain and in order on synthetic bags: {cases} "
        f"cases (D 1, 10, 16, 18, 128; fp32 and bf16; lengths 0-64, "
        f"all-empty, N = 0, single-row; ids out of range) and "
        f"{len(more)} more (bags longer than a chunk and across its "
        f"tiles, offsets[0] > 0, a malformed CSR, table views at odd rows "
        f"and elements, the ten path shapes at 100,000 rows; each twice, "
        f"bit-equal), every bag bit-equal to the in-order sum, max abs err "
        f"from the plain version {err:.3g}")
    return err


def small_configs_against_cpu(seed: int) -> None:
    """The four forwards and the retrieval step at ``reduced_config``: on
    the card (the kernel) against the same weights and batch on the CPU
    (plain lookups, CPU products), within ``SMALL_TOL``."""
    for arch, _, _ in RECSYS_CELLS:
        cfg = registry.reduced_config(arch)
        entry = registry.get(arch)
        p_cpu = rsteps.init_params_for(entry, cfg, seed=seed, device="cpu")
        p_gpu = cconv.recsys_params_from_numpy(
            cconv.recsys_params_to_numpy(p_cpu), cfg, device="cuda")
        rng = np.random.default_rng(seed)
        for shape in ("serve_p99", "retrieval_cand"):
            spec = dataclasses.replace(registry.get_shape(arch, shape),
                                       global_batch=64,
                                       extras=(("n_candidates", 500),))
            b = recsys_batch(cfg, spec, rng, "cpu")
            want = serve_call(cfg, spec, p_cpu, b, "cpu")[0]()
            got = serve_call(cfg, spec, p_gpu,
                             {k: v.cuda() for k, v in b.items()})[0]()
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                       err_msg=f"{arch} {shape}",
                                       **SMALL_TOL)
    log(f"reduced configs: the four forwards and retrieval on the card "
        f"agree with the CPU within {SMALL_TOL}")


def bag_timing(name, call, launches: int) -> dict:
    """The kernel (warm, flushed: ``ms``, and by the profiler), its plain
    version and the library yardstick (``F.embedding_bag``,
    include_last_offset; timed only), flushed, on one captured call of
    the path, and the call's byte bound."""
    table, idx, off, mode = call
    R, D = table.shape
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    lib_idx = idx.clamp(0, R - 1)

    def kernel():
        return ops.embedding_bag(table, idx, off, mode)
    needed, every = tbag.bound_bytes(R, D, table.element_size(), idx, off)
    lo, hi = tbag.bag_bounds(off, idx.numel())
    row = dict(
        launches=launches, ms=cuda_ms_cold(kernel, flush),
        ms_warm=cuda_ms(kernel),
        device_ms=profiled_ms(kernel, "embedding_bag")[0],
        plain_ms=cuda_ms_cold(
            lambda: ref.embedding_bag_ref(table, idx, off, mode), flush),
        library_ms=cuda_ms_cold(lambda: torch.nn.functional.embedding_bag(
            lib_idx, table, off, mode=mode, include_last_offset=True),
            flush),
        bytes=needed, bound_ms=needed / HBM_BYTES_PER_S * 1e3,
        bound_every_row_ms=every / HBM_BYTES_PER_S * 1e3,
        shape=(f"{off.numel() - 1} bags x {float((hi - lo).float().mean()):g}"
               f" rows, D {D}, {str(table.dtype)[6:]}, {mode}"))
    dev = row["device_ms"]
    log(f"kernel embedding_bag at {name} ({row['shape']}; {launches} "
        f"launches a run): kernel {row['ms_warm']:.4f} ms warm, "
        f"{row['ms']:.4f} flushed, "
        f"{'not measured' if dev is None else f'{dev:.4f}'} by the "
        f"profiler; "
        f"plain {row['plain_ms']:.4f} ms, library (F.embedding_bag) "
        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({needed} bytes, distinct rows once; "
        f"{row['bound_every_row_ms']:.4f} ms counting every looked-up row)")
    return row


def recsys_cell(arch, shape, cfg, params, rng) -> dict:
    """One (config, shape) cell: the counted run (2 warm-ups, 10 timed
    batches, then a traced session of 2: its warm call and the traced
    one), then checks (a) and (c) and the launch count."""
    spec = registry.get_shape(arch, shape)
    batch = recsys_batch(cfg, spec, rng)
    call, per_call = serve_call(cfg, spec, params, batch)
    n_out = (spec.extra("n_candidates") if spec.kind == "retrieval"
             else spec.global_batch)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    times = []
    for _ in range(WARM + TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    prof = device_profile(call, warm=True)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_calls = WARM + TIMED + 2
    if counts["embedding_bag"] != n_calls * per_call or \
            sum(counts.values()) != counts["embedding_bag"]:
        raise AssertionError(f"{arch} {shape}: launches {counts}, expected "
                             f"{n_calls * per_call} embedding_bag")
    for o in (out, prof["out"]):
        if o.shape != (n_out,) or not torch.isfinite(o).all():
            raise AssertionError(f"{arch} {shape}: output of shape "
                                 f"{tuple(o.shape)} (expected {n_out}) or "
                                 f"not finite")

    # (a) the kernel against its plain version on this path's own calls
    captured = []

    def capture(table, idx, off, mode="sum"):
        captured.append((table, idx, off, mode))
        return real(table, idx, off, mode)
    with bags_through(capture) as real:
        got = call()
    bag_err = 0.0
    for i, (t, idx, off, mode) in enumerate(captured):
        bag_err = max(bag_err, check_bag(
            f"{arch} {shape} call {i}", real(t, idx, off, mode), t, idx,
            off, mode))
    # (c) the whole forward against its plain-lookup twin
    with bags_through(ref.embedding_bag_ref):
        want = call()
    fwd_err = float((got - want).abs().max())
    scale = max(float(want.abs().max()), 1e-3)
    if fwd_err > FWD_ERR * scale:
        raise AssertionError(f"{arch} {shape}: output differs from the "
                             f"plain-lookup twin by {fwd_err} (limit "
                             f"{FWD_ERR} x {scale})")
    multi = [i for i, (_, _, off, _) in enumerate(captured)
             if bool(((off[1:] - off[:-1]) > 1).any())]
    med = float(np.median(times[WARM:]))
    log(f"recsys {arch} {shape}: {med:.3f} ms per batch (median of "
        f"{TIMED}; {', '.join(f'{t:.2f}' for t in times[WARM:])}), "
        f"{n_out / med * 1e3:.0f} {'candidates' if spec.kind == 'retrieval' else 'samples'}"
        f"/s; peak device memory {peak / 2**30:.2f} GiB; traced batch "
        f"wall {prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} "
        f"ms ({100 * prof['idle']:.0f}% idle), {prof['events']} device "
        f"events; top: {top_ops(prof, 3)}")
    log(f"recsys {arch} {shape} checks: {len(captured)} embedding_bag "
        f"calls ({len(multi)} with multi-row bags) against the plain "
        f"version, max abs err {bag_err:.3g}; output vs plain-lookup twin "
        f"max abs err {fwd_err:.3g} (|out| max {scale:.3g}); launches "
        f"{counts['embedding_bag']} = {n_calls} x {per_call}")
    return dict(ms=med, per_s=n_out / med * 1e3, peak_bytes=peak,
                idle=prof["idle"], wall_traced_ms=prof["wall_ms"],
                busy_traced_ms=prof["busy_ms"],
                launches=counts["embedding_bag"], bag_err=bag_err,
                fwd_err=fwd_err, captured=captured)


def phase_recsys(seed: int):
    """Phase 6; returns the embedding_bag kernel row."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    log(f"recsys serving: device memory in use at start "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; TF32 off")
    err = synthetic_bags(seed)
    small_configs_against_cpu(seed)
    launches, cells, timing = 0, {}, {}
    rng = np.random.default_rng(seed)
    for arch, shapes, change in RECSYS_CELLS:
        cfg = dataclasses.replace(registry.get(arch).config, **change)
        t0 = time.perf_counter()
        params = rsteps.init_params_for(registry.get(arch), cfg, seed=seed,
                                        device="cuda")
        torch.cuda.synchronize()
        tb = params["table"]
        log(f"recsys {arch}: random {cfg.param_dtype} weights from seed "
            f"{seed} in {time.perf_counter() - t0:.1f} s; table "
            f"{tuple(tb.shape)} ({tb.numel() * tb.element_size() / 2**30:.2f}"
            f" GiB), embed_dim {cfg.embed_dim}, {cfg.n_sparse} fields"
            + (f", changes {change}" if change else ""))
        for shape in shapes:
            r = recsys_cell(arch, shape, cfg, params, rng)
            launches += r["launches"]
            err = max(err, r["bag_err"])
            cell = f"{arch}/{shape}"
            sites = [s for c, s in tbag.PATH_SITES if c == cell]
            for site, call in zip(sites, r.pop("captured")):
                timing[f"{cell} {site}"] = bag_timing(
                    f"{cell} {site}", call, r["launches"] // len(sites))
            cells[cell] = r
            torch.cuda.empty_cache()
        del params, tb
        gc.collect()
        torch.cuda.empty_cache()
    if len(timing) != len(tbag.PATH_SITES):
        raise AssertionError(f"timed {len(timing)} embedding_bag calls, "
                             f"expected {len(tbag.PATH_SITES)}")
    gap = sum(t["launches"] * (t["ms"] - t["bound_ms"])
              for t in timing.values())
    log(f"embedding_bag over the ten path calls: launches x (flushed ms - "
        f"bound ms) = {gap:.4f} ms a run")
    main = timing["dcn-v2/serve_bulk " + tbag.PATH_SITES[1][1]]
    log("recsys serving: " + json.dumps({"cells": cells, "kernel": timing}))
    return dict(
        name="embedding_bag", route="cuda", source=SOURCES["embedding_bag"],
        replaces=REPLACES["embedding_bag"], launches=launches,
        path="recsys_serve", max_abs_err=err, ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by="bytes", library_ms=main["library_ms"])


def save_bag_calls(path: str, seed: int) -> None:
    """``--bag-calls``: phase 6's cells, one entry-point call each, with
    every ``embedding_bag`` call's inputs captured and saved to ``path``
    (``tbag.save_calls``) for ``launch/time_embedding_bag.py --calls``;
    the same batches as phase 6 (one generator from ``seed``, the cells
    in order)."""
    rng = np.random.default_rng(seed)
    calls = []
    for arch, shapes, change in RECSYS_CELLS:
        cfg = dataclasses.replace(registry.get(arch).config, **change)
        params = rsteps.init_params_for(registry.get(arch), cfg, seed=seed,
                                        device="cuda")
        for shape in shapes:
            spec = registry.get_shape(arch, shape)
            call, per_call = serve_call(cfg, spec, params,
                                        recsys_batch(cfg, spec, rng))
            cell = f"{arch}/{shape}"
            sites = [s for c, s in tbag.PATH_SITES if c == cell]
            got = []

            def capture(table, idx, off, mode="sum"):
                got.append(dict(
                    cell=cell, site=sites[len(got)],
                    table_shape=list(table.shape),
                    table_dtype=str(table.dtype)[6:], mode=mode,
                    launches=(WARM + TIMED + 2), indices=idx.cpu(),
                    offsets=off.cpu()))
                return real(table, idx, off, mode)
            with bags_through(capture) as real:
                call()
            if len(got) != per_call:
                raise AssertionError(f"{cell}: {len(got)} calls captured, "
                                     f"expected {per_call}")
            calls += got
        del params
        gc.collect()
        torch.cuda.empty_cache()
    size = tbag.save_calls(path, calls)
    log(f"saved {len(calls)} embedding_bag calls of phase 6 to {path} "
        f"({size / 2**20:.1f} MiB)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--segment-log2", type=int, default=23,
                    help="docs per segment = 2**N (the vocabulary scales "
                         "with it: 2**(N-3) terms)")
    ap.add_argument("--paged-only", action="store_true",
                    help="run only the build and the paged-serving phase")
    ap.add_argument("--recsys-only", action="store_true",
                    help="run only the build and the recsys-serving phase")
    ap.add_argument("--intersect-calls", default="", metavar="PATH",
                    help="run only the build and phase 4, and save the "
                         "sequential route's intersect_mask inputs to PATH "
                         "(for launch/time_intersect_mask.py --calls)")
    ap.add_argument("--bag-calls", default="", metavar="PATH",
                    help="run only the build and phase 6's captures, and "
                         "save its ten embedding_bag calls to PATH (for "
                         "launch/time_embedding_bag.py --calls)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = nvidia_smi()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    build_s = _cuda.build_seconds()
    log(f"kernels built and loaded in {build_s:.1f} s")

    table = []
    saving = args.intersect_calls or args.bag_calls
    if args.intersect_calls:
        phase_small(args.intersect_calls)
    elif args.bag_calls:
        save_bag_calls(args.bag_calls, seed=0)
    elif not (args.paged_only or args.recsys_only):
        table = phase_index(args.segment_log2)
    if not (args.recsys_only or saving):
        t0 = time.perf_counter()
        row, counts, paged_sum = phase_paged(seed=0)
        table.append(dict(
            name="paged_attention", route="cuda",
            source=SOURCES["paged_attention"],
            replaces=REPLACES["paged_attention"],
            launches=counts["paged_attention"], path="paged_serve",
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by="bytes", library_ms=row["library_ms"]))
        log("paged serving: " + json.dumps(paged_sum))
        log(f"paged phase {time.perf_counter() - t0:.1f} s")
    if not (args.paged_only or saving):
        t0 = time.perf_counter()
        table.append(phase_recsys(seed=0))
        log(f"recsys phase {time.perf_counter() - t0:.1f} s")
    log(f"wall {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": table}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
