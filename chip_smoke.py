"""Drive the PyTorch/CUDA port (the streaming index, single-device and
document-sharded, the paged-KV decoder server, recsys serving, the LMs'
forward, prefill and decode, training, SchNet, and the mesh layer's
one-device mesh, dry-run and roofline) on one GPU.

    python3 chip_smoke.py

Phases, in order (any failure raises and exits non-zero):

  1. the card (``nvidia-smi``), torch/CUDA versions, the kernel build;
  2. every CUDA kernel against its plain torch version on the card, at
     the main path's shapes, bit for bit (``bulk_append`` on each edge
     case of ``launch/time_bulk_append.py``, on clones of one state; the
     two frozen-segment kernels
     twice on each edge case of ``launch/time_segment_intersect.py`` and
     twice at the path's shapes, the scored kernel at three thresholds:
     none, about half the blocks skipped, all skipped;
     ``intersect_mask`` twice on each of its edge cases and on three
     pairs padded to max_len: head vs torso, torso vs head, head vs an
     all-pad list) — plus its time, the plain version's, one library
     call's and the bound the card's memory rate sets (for the segment
     kernels and ``intersect_mask`` also L2-flushed and by the
     profiler);
  3. the main path at full width: a Zipf(1.0) tweet stream over a 2**20
     term vocabulary into Earlybird's 2**23-tweet segment under the
     paper's production pools Z^g = <1, 4, 7, 11>, in 4096-tweet arrival
     batches; one rollover (freeze + slice reclamation), 2**20 more
     tweets into the recycled pools, then a 32-query AOL-like batch
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
     greedy token equal); then 33 requests on 32 slots (max_len 2048) in
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
     ``F.embedding_bag`` at each of the ten calls the cells make;
  6r. the recsys steps on ranks, each table sharded by rows: the windowed
     bag kernels on synthetic bags at 2 and 4 windows (each window
     bit-equal to the windowed in-order sum, the windows summing to the
     whole bags, the backward's blocks concatenating to the whole
     gradient bit for bit); then four gloo rank processes on card 0 on a
     (1, 4) ``("data", "model")`` mesh, each with its own block of rows
     made from the seed's stream: (a) DLRM-MLPerf's bf16 table over all
     four (rows over ``("data", "model")``, ``rules_for``'s layout past
     5e7 rows), phase 6's batch through ``make_recsys_forward``: the
     bags bit-equal to phase 6's single-card bags, the logits within
     1e-5; (b) DCN-v2 as published, two AdamW steps at B 16,384 (a
     quarter of train_batch: four ranks carry the batch's activations on
     one card): losses, the table's blocks and moments and every
     replicated leaf within 1e-5 of the same steps on one card.  Each
     rank logs step ms, the bag reduce's bytes and host ms and
     ``max_memory_allocated``, asserts its launches, replays its windowed
     calls against the windowed plain version and times them in its
     turn; a guard on the functional collectives fails any ``DTensor``
     collective of a CUDA tensor over gloo (with a positive control);
  7. search serving through the port's ``ServeLoop``: (a) phase 3's
     full-width engine behind the reference's ``ServeConfig`` and an
     ingest journal takes 2**20 more tweets in 4096-tweet batches
     between requests of every kind, each rung of the degradation
     ladder forced in turn and then the gauge (a burst meets the ingest
     queue's backpressure); every response is held against the brute
     force over the docs applied before its dispatch, sliced per rung,
     every acked batch is read back from the journal, and
     ``check_serve`` and ``check_engine`` run on the final state; (c)
     the paper's Table 2: phase 3's frozen segment is the history H, a
     fresh 2**23-tweet stream over the same dictionary is indexed into
     one segment under each SP policy (pools sized from its own start
     table): overflow 0 and slots equal to ``memory_slots_sp``, with the
     waste against SP(z0) and the top-10,000 churn; (b) after phase 4,
     at its 2**16-tweet segments, a ``validate=True`` engine behind the
     loop dies inside a rollover with requests in flight, is recovered
     on the card and resumed (every acked batch read back, fingerprint
     equal to an uncrashed engine's), and every ``FaultPlan`` kind runs
     with ``device="cuda"``.  Phases 7a and 7c run right after phase 3,
     on its engine and its stream.

  8. the document-sharded index: (a) the first 2**19 + 2**16 tweets of
     phase 3's stream through a ``ShardedLifecycleEngine`` over
     ``make_doc_mesh(4)`` (docid d on shard d % 4, every shard's
     ``[S, ...]`` state stacked on the card, 2**21-tweet segments as
     2**17 local docs a shard, pools sized from each shard's own
     substream), one rollover, 2**16 more tweets, 8 queries of every
     kind (one batch) held against a brute force of its own (a sixteenth
     of the segment: 8c runs the full width); ``bulk_append`` launched 4
     times a batch, ``intersect_mask`` (the shards' batched
     conjunctions) and the two batched frozen-segment kernels
     launched; the sharded route's own
     ``intersect_mask`` calls replayed bit-equal to the plain version
     and timed beside their bound and ``searchsorted`` + ``gather``;
     ingest docs/s, rollover s, ms per query batch, traced batches,
     peak memory and each shard's slots; (b) at
     phase 4's 2**16-tweet segments: >= 3 rollovers with compaction,
     batched == ``batched=False`` == brute force, journal + snapshot,
     recovery on the card with an equal fingerprint, a two-shard mesh
     and a truncated archive refused, every ``FaultPlan`` kind on four
     shards, and the ServeLoop over a sharded engine (emergency
     rollover, a rejection with retry-after, ``check_serve`` and
     ``check_engine``); (c) the index on ranks, one shard per process
     (``make_rank_mesh``, ``torch.distributed``): (i) four gloo ranks
     on card 0 (NCCL refuses two ranks of one communicator on one GPU)
     take phase 3's stream at full width (Earlybird's 2**23-tweet
     segment, 2**21 local docs a rank), each indexing its own shard's
     block of every batch, then phase 3's first 8 queries of each kind;
     the snapshot taken on the ranks is restored here as the stacked
     four-shard engine with an equal fingerprint, and every rank's
     answer must equal phase 3's brute force and that engine's;
     ``bulk_append`` asserted once a batch on each rank and the three
     query kernels launched on each, each rank's own ``intersect_mask``
     calls (at full width) replayed bit-equal to the plain version after
     the counts are read; per rank docs/s, rollover s, ms per
     query batch, launches, ``max_memory_allocated`` and the card's used
     memory; then, on the same full-width engine, the ranked
     ``ServeLoop`` (shard 0's rank leads on its clock and broadcasts a
     plan a step; the others follow): one step under the gauge, one at
     rung 0 and one at rung 3, each with a 4096-tweet batch and one
     request of each kind, every dispatch taking the card's turn for its
     frozen side; the leader's responses held here against the brute
     force at their rungs, every rank's ``check_serve`` ok and its
     ``bulk_append`` launches = applied batches, the three query kernels
     launched on every rank; then, with that engine freed, at (b)'s
     depth a crash inside a rollover under the ranked loop with requests
     in flight, ``recover(mesh=)`` and ``resume_with`` on every rank
     (fingerprint equal to an uncrashed ranked run's) and every
     ``FaultPlan`` kind on the ranks; (ii) one NCCL rank at (b)'s depth,
     beside (i) on the card, with ``validate=True``, every
     kind batched and ``batched=False`` against the brute force; (iii)
     four NCCL ranks, one a card, at (i)'s size, only where the machine
     has four cards (the log says whether it ran).  Phase 8 runs last
     of the index phases, after phase 3's engine is gone.

  9. the LMs at full width, one on the card at a time, random weights
     from seed 0 (no kernel of the repo is on this path: attention and
     the MoE dispatch are plain torch): Gemma3-12B as published (48
     layers, 40 local with a 1024-token window + 8 global, bf16):
     ``lm_prefill`` at B = 1 x 32,768 (cache shapes, finite logits),
     ``lm_forward`` and ``lm_loss`` at B = 1 x 4,096 (the prefill's last
     logits against the forward's last row; the loss against a float64
     cross-entropy of the forward's logits), a traced forward; past the
     window at one group's depth (5 local + 1 global) in fp32: 1024
     + 64 tokens decoded one at a time against the forward at every
     position, and with the int8 cache against the exact decode;
     Qwen2-MoE-A2.7B as published (24 layers, 60 experts top 4 + 4
     shared): prefill at B = 1 x 32,768, prefill against forward at
     4,096 with each layer's drop fraction, one layer's grouped
     dispatch against the token path in fp32, decode against forward
     over 128 tokens in fp32; Grok-1-314B at its widths, 2 of 64 layers:
     prefill against forward at B = 1 x 8,192; TinyLlama-1.1B: the
     prefill's bf16 cache of 256 tokens against the dense decode's,
     built token by token.

  10. training, every model from a seed: (a) the ``embedding_bag_backward``
     kernel (the table gradient of phase 6's bags) against its plain
     version at DCN-v2's train_batch shapes (65,536 x 26 single-row bags
     into the 33,762,816 x 16 fp32 table), on a Zipf(1.1) id stream, on
     mean bags with empty ones, clipped ids and positions outside every
     bag, on a bf16 table and on one row of 110,000 contributions: each
     call twice and bit-equal, bit-equal to ``in_order_backward`` (the
     kernel's order in plain torch), rows of one contribution bit-equal
     to the plain version, the rest within 1e-5 of their summed
     magnitudes; small calls at every lane width (D 1, 2, 10, 18 and 16
     at an odd address), whole and in windows, bit-equal to the in-order
     sum; its time warm, flushed and by the
     profiler beside the plain version, ``zeros + index_add_`` and the
     bound; (b) exact restart: ``launch/train.py`` (TinyLlama's smoke
     preset) crashed at step 9 and resumed, in a subprocess (the
     launcher's deterministic mode), against an uninterrupted run; DCN-v2 as published
     through ``TrainLoopRunner`` (6 steps, saves every 2, a failure at
     step 5): every parameter and moment bit-equal; (c) one AdamW step
     on the card against the same step on the CPU: TinyLlama-1.1B's
     widths at 2 layers in fp32 (2 x 256 tokens, 2 microbatches) and the
     four recsys archs at ``reduced_config``; (d) full-width training
     steps: TinyLlama-1.1B as published (bf16, 8 x 4,096 tokens, 2
     microbatches, remat; a traced step), Qwen2-MoE-A2.7B at its widths
     with 2 of 24 layers (2 x 4,096), Gemma3-12B's first local/global
     group (6 layers, 1 x 4,096), and DCN-v2 at train_batch (B 65,536;
     (b)'s uninterrupted run, each step timed, one traced, the bag
     launches counted).

  11. SchNet at its published widths (3 interactions, d_hidden 64, n_rbf
     300, cutoff 10, fp32; no kernel of the repo is on this path: the
     message passing is ``index_select`` and ``index_add_``), in
     deterministic mode with TF32 off, random weights and data from seed
     0: (a) forward, loss and one AdamW step on the card against the
     port's CPU path at the reduced config (50 nodes, 200 edges) and at
     full_graph_sm's shapes (2,708 nodes, 10,556 edges, d_feat 1,433);
     (b) minibatch_lg: a Reddit-scale random graph (232,965 nodes x 492
     = 114,618,780 edges) built with the card's sort, 1,024 seeds
     sampled with fanout (15, 10) and padded to (180,224, 179,200),
     d_feat 602; (c) molecule: 128 molecules of 30 atoms and 64 edges,
     a readout a molecule; full_graph_sm too: 5 train steps each (the
     last traced; s per step, edges/s, peak memory, idle share, top
     ops); (d) a step repeated from the same state gives equal bits;
     then minibatch_lg's steps timed outside deterministic mode.

  12. the mesh layer (``dist/sharding.py``, ``launch/dryrun.py``,
     ``launch/roofline.py``; no kernel): (a) TinyLlama-1.1B's forward at
     full width (bf16, 1 x 4,096, phase 10's tree from seed 0) plainly
     and with its parameters as DTensors on the card's one-device NCCL
     mesh under the cell's rules: the logits bit-equal (else the first
     op that differs is reported); (b) the dry-run of tinyllama-1.1b
     train_4k and dcn-v2 serve_p99 at full width on the fake (16, 16)
     mesh, one subprocess each; (c) for each step that phases 6, 9, 10
     and 11 time (DCN-v2 serve_bulk and train_batch, Gemma3-12B's and
     Qwen2-MoE's 32k prefill, TinyLlama-1.1B's 8 x 4,096 train step,
     SchNet minibatch_lg), the dry-run on ``--mesh card`` at the shape the
     phase ran: its roofline bound and term at the dtype's peak beside
     the phase's median, ``mfu`` = model FLOPs / (median x peak), and
     the dry-run's memory beside the phase's ``max_memory_allocated``.
     (b) and (c)'s dry-runs start at the script's start, niced, one
     thread each, and run beside the other phases.

``--paged-only`` runs phases 1 and 5 alone, ``--recsys-only`` phases 1
and 6, ``--serve-only`` phases 1, 3 and 7, ``--sharded-only`` phases 1
and 8 (with a brute force of its own), ``--lm-only`` phases 1 and 9,
``--train-only`` phases 1 and 10, ``--gnn-only`` phases 1 and 11,
``--ranks-only`` phases 1 and 8c (with a brute force of its own; short
rehearsals), ``--recsys-ranks-only`` phases 1 and 6r (with a DLRM
reference of its own);
``--intersect-calls PATH`` phases 1 and 4,
saving the sequential route's ``intersect_mask`` inputs to ``PATH`` for
``launch/time_intersect_mask.py --calls``; ``--segment-calls PATH``
phases 1, 3 and 4, saving the main path's 8 + 8
``segment_intersect_mask_batched`` and ``scored_intersect_batched``
inputs and the sequential route's ``segment_intersect_mask`` inputs to
``PATH`` for ``launch/time_segment_intersect.py --calls``;
``--bag-calls PATH`` phase 1 and one call of each phase-6 cell, saving
its ten ``embedding_bag`` calls to ``PATH`` for
``launch/time_embedding_bag.py --calls``; ``--launch-only`` phases 1 and
12 (no phase times, so (c) prints bounds only), then the dry-run sweep
of all 36 cells on both fake meshes (``dryrun --all --jobs 8 --set
probe=True``; ``--sweep-out PATH`` keeps its JSON lines), with its wall
time.

The last two lines are the kernel table as JSON, the card's name and
power limit, and the result line.  The script imports only torch, numpy
and the port (``src/repro_torch``); it needs one CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
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

from repro_torch.analysis import faults, invariants  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import analytical  # noqa: E402
from repro_torch.core import convert as cconv  # noqa: E402
from repro_torch.core import history, policies  # noqa: E402
from repro_torch.core import pointers  # noqa: E402
from repro_torch.core import recovery  # noqa: E402
from repro_torch.core import serve, slicepool  # noqa: E402
from repro_torch.core.index import ActiveSegment, flatten  # noqa: E402
from repro_torch.core.lifecycle import (  # noqa: E402
    AdmissionController, LifecycleEngine, ShardedLifecycleEngine)
from repro_torch.core.sharded_index import (  # noqa: E402
    engine_max_len, make_doc_mesh, make_rank_mesh)
from repro_torch.core.segments import CompactionPolicy  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.dist.collectives import process_world  # noqa: E402
from repro_torch.kernels import _cuda, ops, ref  # noqa: E402
from repro_torch.kernels import embedding_bag as keb  # noqa: E402
from repro_torch.kernels import paged_attention as pa_kernel  # noqa: E402
from repro_torch.kernels import segment_intersect as si  # noqa: E402
from repro_torch.kernels.timing import (cuda_ms, cuda_ms_cold,  # noqa: E402
                                        profiled_ms, profiled_total_ms)
from repro_torch.launch import serve as paged_serve  # noqa: E402
from repro_torch.launch import time_bulk_append as tba  # noqa: E402
from repro_torch.launch import time_embedding_bag as tbag  # noqa: E402
from repro_torch.launch import time_embedding_bag_backward as tbwd  # noqa: E402,E501
from repro_torch.launch import time_intersect_mask as tim  # noqa: E402
from repro_torch.launch import time_segment_intersect as tsg  # noqa: E402
from repro_torch.data import graph_sampler as gsamp  # noqa: E402
from repro_torch.data import lm_data as tlm_data  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.models import recsys as rmodels  # noqa: E402
from repro_torch.models import schnet as gsch  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402
from repro_torch.paged import kv_cache as kv  # noqa: E402
from repro_torch.paged import serve_model as sm  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import elastic as telastic  # noqa: E402
from repro_torch.train import optimizer as toptim  # noqa: E402
from repro_torch.train import steps as rsteps  # noqa: E402
from repro_torch.train import tree as ttree  # noqa: E402
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
    # no Pallas kernel: the gradient of the table read, XLA's transpose
    # of the reference's jnp.take
    "embedding_bag_backward": "src/repro/models/recsys.py:55",
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
    "embedding_bag_backward": "src/repro_torch/csrc/embedding_bag_backward.cu",
}
SCORED_K = 10                # the scored top-k route's k
MAIN_QUERIES = 32            # phase 3's queries of each kind (a depth cut)
INVALID = 0xFFFFFFFF         # the lists' pad and the heap's NULL


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
def _zipf_corpus_on_card(spec) -> np.ndarray:
    """``synth.zipf_corpus(spec)`` with its inverse-CDF search on the card:
    numpy's ``Generator.choice(n, size, p=p)`` draws ``rng.random(size)``
    and searches ``p``'s normalised cumulative sum (side="right"), so the
    same draws searched by ``torch.searchsorted`` give the same ids, in a
    fraction of the host's time (about 100M draws a full-width stream)."""
    rng = np.random.default_rng(spec.seed)
    probs = synth._zipf_probs(spec.vocab, spec.alpha)
    perm = rng.permutation(spec.vocab)
    lens = np.clip(rng.poisson(spec.mean_len, spec.n_docs), 1, spec.max_len)
    docs = np.full((spec.n_docs, spec.max_len), -1, np.int32)
    cdf = probs.cumsum()
    cdf /= cdf[-1]
    u = torch.as_tensor(rng.random(int(lens.sum())), device="cuda")
    idx = torch.searchsorted(torch.as_tensor(cdf, device="cuda"), u,
                             right=True).cpu().numpy()
    docs[np.arange(spec.max_len)[None, :] < lens[:, None]] = perm[idx]
    return docs


def make_stream(vocab: int, n_docs: int, seed: int) -> np.ndarray:
    """``synth.zipf_corpus``'s stream, its search on the card; a small
    stream must first come out bit-equal to numpy's own."""
    spec = synth.CorpusSpec(vocab=vocab, n_docs=n_docs, mean_len=11,
                            max_len=70, alpha=1.0, seed=seed)
    small = dataclasses.replace(spec, vocab=4096, n_docs=20000)
    if not np.array_equal(_zipf_corpus_on_card(small),
                          synth.zipf_corpus(small)):
        raise AssertionError("tweet streams: the inverse-CDF search on the "
                             "card does not give numpy's stream")
    return _zipf_corpus_on_card(spec)


def next_stream(vocab: int, n_docs: int, seed: int,
                dict_seed: int) -> np.ndarray:
    """A fresh stream — ``seed``'s tweet lengths and draws — over the
    dictionary of the stream made from ``dict_seed``: the generator
    gives each seed its own rank -> term-id permutation, so the terms
    are relabelled to keep each term's popularity, as one day's tweets
    follow the day before."""
    docs = make_stream(vocab, n_docs, seed)
    rank = np.empty(vocab, np.int64)
    rank[np.random.default_rng(seed).permutation(vocab)] = np.arange(vocab)
    relabel = np.random.default_rng(dict_seed).permutation(vocab)[rank]
    return np.where(docs >= 0, relabel[np.maximum(docs, 0)],
                    -1).astype(np.int32)


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

    def docs_of(self, t: int, n=None) -> np.ndarray:
        return self.tf_of(t, n)[0]

    def tf_of(self, t: int, n=None):
        """(ascending docs, term frequency in each) of one term, over the
        whole stream or its first ``n`` docs."""
        t = int(t)
        if t not in self._tf:
            self._tf[t] = np.unique(self.lists[t][0], return_counts=True)
        ids, tf = self._tf[t]
        if n is None:
            return ids, tf
        cut = np.searchsorted(ids, n)
        return ids[:cut], tf[:cut]

    def scored(self, terms, n=None):
        """Docs holding every term, ranked by sum of min(tf, 255) desc,
        then docid desc: (docs, scores)."""
        its = [self.tf_of(t, n) for t in terms]
        ids = its[0][0]
        for more, _ in its[1:]:
            ids = np.intersect1d(ids, more)
        sc = np.zeros(ids.size, np.int64)
        for uids, tf in its:
            sc += np.minimum(tf[np.searchsorted(uids, ids)], SCORE_MAX)
        order = np.lexsort((-ids, -sc))
        return ids[order], sc[order]

    def conjunctive(self, terms, n=None) -> np.ndarray:
        out = self.docs_of(terms[0], n)
        for t in terms[1:]:
            out = np.intersect1d(out, self.docs_of(t, n))
        return out[::-1]

    def disjunctive(self, terms, n=None) -> np.ndarray:
        out = self.docs_of(terms[0], n)
        for t in terms[1:]:
            out = np.union1d(out, self.docs_of(t, n))
        return out[::-1]

    def phrase(self, t1: int, t2: int, n=None) -> np.ndarray:
        d1, p1 = self.lists[int(t1)]
        d2, p2 = self.lists[int(t2)]
        if n is not None:
            c1, c2 = np.searchsorted(d1, n), np.searchsorted(d2, n)
            d1, p1, d2, p2 = d1[:c1], p1[:c1], d2[:c2], p2[:c2]
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
def segment_edge_cases() -> int:
    """The two frozen-segment kernels on the card against their plain
    versions on the edge cases of ``launch/time_segment_intersect.py``
    (docids at a b-block's first, last and in a gap; an a-block that
    needs 128 b-blocks, a window wider than a block, a-blocks that need
    none; many a-blocks on one b-block; bw 1, 2 and 4 in a row;
    part-filled blocks; ns = 0 rows, an empty b; NB = 1 and 4,096; 1 and
    64 rows; docids 0, 0xFFFFFFFE and INVALID): the batched call, each
    row as a single pair, and the scored call at three thresholds (255 +
    255 hits, b impacts of 0, a bound that wraps): bit for bit, twice.
    Returns the count of cases."""
    cases = [("segment_intersect_mask_batched", n, (a, b))
             for n, a, b in tsg.edge_stacks(si)]
    cases += [("segment_intersect_mask", n, (a, b))
              for n, a, b in tsg.edge_pairs(si)]
    cases += [("scored_intersect_batched", n, (a, b, rest, th))
              for n, a, b, rest, th in tsg.scored_edge_cases(si)]
    for kernel, name, args in cases:
        want = getattr(ref, kernel + "_ref")(*args)
        for k in range(2):
            require_equal(f"{kernel}/{name} (call {k})",
                          getattr(ops, kernel)(*args), want)
    torch.cuda.synchronize()
    return len(cases)


def bulk_append_edge_cases() -> int:
    """``bulk_append`` on the card against its plain version on the edge
    cases of ``launch/time_bulk_append.py`` (lane counts at the kernel's
    tile, lanes-a-thread and wave edges, 8a's and phase 2's batches;
    streams at storage offset 1; every lane skipping, every lane
    landing, random landings; the addresses -1, H - 1, H, 2**40, V - 1
    and V), each on clones of one state: heap, tail and freq bit for
    bit.  Returns the count of cases."""
    state = tba.edge_state(device="cuda")
    cases = tba.edge_cases(
        torch.cuda.get_device_properties(0).multi_processor_count)
    for name, scat in cases:
        got = [t.clone() for t in state]
        want = [t.clone() for t in state]
        ops.bulk_append(*got, *scat)
        ref.bulk_append_ref(*want, *scat)
        torch.cuda.synchronize()
        for part, g, w in zip(("heap", "tail", "freq"), got, want):
            require_equal(f"bulk_append/{name}/{part}", g, w)
    return len(cases)


def segment_times(kernel: str, call, flush) -> dict:
    """Warm, L2-flushed and profiler times of one frozen-segment call."""
    dev_ms, seen = profiled_ms(call, tsg.KERNEL_NAMES[kernel])
    return dict(ms=cuda_ms(call), ms_cold=cuda_ms_cold(call, flush),
                device_ms=dev_ms, kernels_seen=seen)


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
    if docs.shape[0] == tba.STREAM_DOCS and (
            layout.slices_per_pool != tba.PHASE2_POOLS or not np.array_equal(
                docs[:5 * BATCH], tba.stream_prefix(5 * BATCH))):
        raise AssertionError("launch/time_bulk_append.py no longer rebuilds "
                             "phase 2's batch (its stream or its pools)")
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
    H, V = st.heap.shape[0], st.tail.shape[0]
    live = tba.landing(scat, H, V)
    b = tba.bound_bytes(scat, H, V)
    n, nbytes = b["lanes"], b["bytes"]
    skips = n - b["postings"]
    if skips == 0:
        raise AssertionError("bulk_append case has no skip lanes")
    n_edge = bulk_append_edge_cases()
    log(f"bulk_append: {n_edge} edge cases bit-identical on clones of one "
        f"state")
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
        shape=f"N={n} lanes ({b['postings']} postings, {b['pointers']} "
              f"pointers, {b['terms']} terms land; {skips} skip), heap {H}")
    # the same call L2-flushed, and the profiler's own kernel durations:
    # its streams (15.5 MB) fit the 50 MB L2, so warm repeats may beat HBM
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    r = rows["bulk_append"]
    r["ms_cold"] = cuda_ms_cold(lambda: ops.bulk_append(*k_out, *scat), flush)
    r["device_ms"], seen = profiled_ms(
        lambda: ops.bulk_append(*k_out, *scat), "bulk_append_kernel")
    old = b["bytes_all_lanes"]
    log(f"bulk_append: {r['ms_cold']:.4f} ms L2-flushed; profiler "
        + ("not measured" if r["device_ms"] is None else
           f"{r['device_ms']:.4f} ms per launch") + f" ({seen} kernels "
        f"seen); bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} "
        f"bytes as the batch needs them: every lane's three addresses, the "
        f"landing lanes' values read and written; "
        f"{old / HBM_BYTES_PER_S * 1e3:.4f} ms for all seven streams of "
        f"every lane, {old} bytes)")
    del seg, st, k_out, r_out, pre, flush
    torch.cuda.empty_cache()

    # -- the segment kernels on lists shaped like a full segment's ------
    # a query batch's driving pairs: a head term, torso and tail terms,
    # a pad row (empty list); densities give bw 1, 2 and 4 blocks
    n_seg_edge = segment_edge_cases()
    log(f"frozen-segment kernels: {n_seg_edge} edge cases bit-identical "
        f"twice")
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    la = tsg.segment_lists(rng, seg_docs, tsg.DENS_A[:q_rows])
    lb = tsg.segment_lists(rng, seg_docs, tsg.DENS_B[:q_rows])
    pa = [pack_docids(x) for x in la]
    pb = [pack_docids(x) for x in lb]
    bws = np.concatenate([np.asarray(p.bws[: -(-p.n // SEG_BLOCK)])
                          for p in pa + pb if p.n])
    if not {1, 2, 4} <= set(bws.tolist()):
        raise AssertionError(f"kernel cases miss a byte width: "
                             f"{sorted(set(bws.tolist()))}")
    sa = stack_packed(pa).to(dev)
    sb = stack_packed(pb).to(dev)
    want = ref.segment_intersect_mask_batched_ref(sa, sb)
    for k in range(2):
        got = ops.segment_intersect_mask_batched(sa, sb)
        torch.cuda.synchronize()
        err = require_equal(f"segment_intersect_mask_batched (call {k})",
                            got, want)
    a_ids, b_ids = decode_stacked(sa), decode_stacked(sb)
    rows["segment_intersect_mask_batched"] = dict(
        **segment_times("segment_intersect_mask_batched",
                        lambda: ops.segment_intersect_mask_batched(sa, sb),
                        flush),
        plain_ms=cuda_ms(
            lambda: ref.segment_intersect_mask_batched_ref(sa, sb)),
        library_ms=cuda_ms(lambda: torch.gather(
            b_ids, 1, torch.searchsorted(b_ids, a_ids).clamp_(
                max=b_ids.shape[1] - 1)) == a_ids),
        bytes=tsg.batched_bytes(si, sa, sb), max_abs_err=err,
        hits=int(got.sum()),
        shape=f"N={sa.firsts.shape[0]} rows, NB={sa.n_blocks} blocks "
              f"(W={sa.n_blocks * SEG_BLOCK}), PW={sa.n_words}")
    del a_ids, b_ids

    # -- single pair: the head list against a torso list ---------------
    a1, b1 = pa[tsg.SINGLE[0]].to(dev), pb[tsg.SINGLE[1]].to(dev)
    want = ref.segment_intersect_mask_ref(a1, b1)
    for k in range(2):
        got = ops.segment_intersect_mask(a1, b1)
        torch.cuda.synchronize()
        err = require_equal(f"segment_intersect_mask (call {k})", got,
                            want)
    d_a, d_b = decode_packed(a1), decode_packed(b1)
    rows["segment_intersect_mask"] = dict(
        **segment_times("segment_intersect_mask",
                        lambda: ops.segment_intersect_mask(a1, b1), flush),
        plain_ms=cuda_ms(lambda: ref.segment_intersect_mask_ref(a1, b1)),
        library_ms=cuda_ms(lambda: torch.gather(
            d_b, 0, torch.searchsorted(d_b, d_a).clamp_(
                max=d_b.shape[0] - 1)) == d_a),
        bytes=tsg.single_bytes(si, a1, b1), max_abs_err=err,
        hits=int(got.sum()),
        shape=f"a {a1.n} docids in {a1.n_blocks} blocks, b "
              f"{b1.n} in {b1.n_blocks}")

    # -- scored_intersect_batched: the same rows with tf impacts --------
    # impacts min(tf, 255) drawn from the stream's head term's per-tweet
    # tf distribution, so block maxima differ and a threshold can split
    first = docs[: 1 << 20]
    head = int(np.bincount(first[first >= 0]).argmax())
    tfs = (first == head).sum(1)
    tfs = tfs[tfs > 0]

    def impacts(n):
        return np.minimum(rng.choice(tfs, n), SCORE_MAX).astype(np.int32)
    sca = stack_scored([attach_scores(p, impacts(p.n)) for p in pa])
    scb = stack_scored([attach_scores(p, impacts(p.n)) for p in pb])
    rows_n = sca.bmax.shape[0]
    rest_np = rng.integers(0, 8, rows_n).astype(np.int32)
    ths = tsg.thresholds(sca.bmax, rest_np, sca.ids.ns)
    sca, scb = sca.to(dev), scb.to(dev)
    rest = torch.as_tensor(rest_np, device=dev)
    bound = (sca.bmax.long() + rest.long()[:, None]).cpu().numpy()
    nreal = (-(-sca.ids.ns.cpu().numpy() // SEG_BLOCK)).astype(np.int64)
    err, skipped, runs = 0, {}, {}
    for name, th in ths.items():
        th = torch.as_tensor(th, device=dev)
        want = ref.scored_intersect_batched_ref(sca, scb, rest, th)
        for k in range(2):
            got = ops.scored_intersect_batched(sca, scb, rest, th)
            torch.cuda.synchronize()
            err = max(err, require_equal(
                f"scored_intersect_batched/{name} (call {k})", got, want))
        live_blk = torch.as_tensor(bound, device=dev) > th.long()[:, None]
        skipped[name] = float(1 - (live_blk.cpu().numpy()[
            np.arange(bound.shape[1])[None, :] < nreal[:, None]]).mean())
        runs[name] = (th, int((got > 0).sum()))
    th0, hits0 = runs["none"]
    if not 0.2 <= skipped["half"] <= 0.8 or skipped["all"] != 1.0:
        raise AssertionError(f"scored thresholds skip {skipped}")
    a_ids, b_ids = decode_stacked(sca.ids), decode_stacked(scb.ids)
    a_sc, b_sc = decode_scores(sca.swords), decode_scores(scb.swords)

    def library():
        pos = torch.searchsorted(b_ids, a_ids).clamp_(max=b_ids.shape[1] - 1)
        hit = torch.gather(b_ids, 1, pos) == a_ids
        return torch.where(hit, a_sc + torch.gather(b_sc, 1, pos), 0)
    th_half = runs["half"][0]
    half = segment_times(
        "scored_intersect_batched",
        lambda: ops.scored_intersect_batched(sca, scb, rest, th_half), flush)
    rows["scored_intersect_batched"] = dict(
        **segment_times("scored_intersect_batched",
                        lambda: ops.scored_intersect_batched(sca, scb, rest,
                                                             th0), flush),
        half=half,
        plain_ms=cuda_ms(lambda: ref.scored_intersect_batched_ref(
            sca, scb, rest, th0)),
        library_ms=cuda_ms(library),
        bytes=tsg.scored_bytes(si, sca, scb, th0, rest), max_abs_err=err,
        hits=hits0,
        shape=f"N={rows_n} rows, NB={sca.ids.n_blocks} blocks, the "
              f"segment rows with impacts from term {head}'s tf "
              f"(max {int(tfs.max())}); th=-1 (main path); blocks "
              f"skipped at the three thresholds "
              f"{', '.join(f'{k} {v:.3f}' for k, v in skipped.items())}; "
              f"kernel at the half threshold {half['ms']:.4f} ms warm, "
              f"{half['ms_cold']:.4f} L2-flushed, "
              + ("profiler not measured" if half["device_ms"] is None else
                 f"{half['device_ms']:.4f} by the profiler"))
    del sca, scb, a_ids, b_ids, a_sc, b_sc, runs, flush
    torch.cuda.empty_cache()
    for name in ("segment_intersect_mask_batched", "segment_intersect_mask",
                 "scored_intersect_batched"):
        r = rows[name]
        log(f"{name}: bit-identical twice; kernel {r['ms']:.4f} ms warm, "
            f"{r['ms_cold']:.4f} L2-flushed, "
            + ("profiler not measured" if r["device_ms"] is None else
               f"{r['device_ms']:.4f} by the profiler")
            + f" ({r['kernels_seen']} kernels seen)")

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
    given (:func:`device_profile`; no queries: the ingest batch alone).
    Runs after the measured main path, whose launch counts it leaves
    alone.  Returns each one's wall and device ms, idle share and top
    ops by name."""
    calls = [("ingest", lambda: eng.ingest(docs))] + [
        (kind, lambda c=call, b=batch: c(b[:q_rows])) for kind, batch, call
        in query_calls(eng, queries, pairs) if len(batch)]
    out = {}
    for name, fn in calls:
        p = device_profile(fn)
        out[name] = {k: p[k] for k in ("wall_ms", "busy_ms", "idle", "top")}
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
    return out


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
               extra_docs: int, q_rows: int, n_queries: int, fmax: int,
               keep: bool = False):
    """The main path; with ``keep`` returns ``(summary, engine)`` so the
    serving phase takes over the full-width engine."""
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
    live = eng.memory_slots_used()
    log(f"pools: high-water {hw_slots} slots at rollover, {hw_after} after "
        f"{extra_docs} more docs (bounded by reclamation); live {live}")
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
        high_water_slots=hw_after, live_slots=live,
        high_water_slots_at_rollover=hw_slots, peak_bytes=peak,
        launches=counts, oracle=(queries, pairs, want))
    if keep:
        return summary, eng
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
# phase 7: search serving through the ServeLoop (ladder, crash, Table 2)
# ---------------------------------------------------------------------------
SERVE_DOCS = 1 << 20          # tweets submitted through the serving loop
SERVE_K = 10                  # k of the top-k and scored requests
FULL_BUCKET = 32              # ServeConfig().max_batch: one full bucket
# (name, forced rung or None for the gauge, arrival batches, steps at
# which requests are submitted, requests at each such step, whether the
# first of those steps is traced).  The light stretches submit two of
# each kind at four or five steps, so the 2 ms timer flushes them; the
# full ones submit a full bucket before every step, so every step
# flushes a full bucket: the rung's capacity.  A traced step is left out
# of the stretch's times and latencies (the profiler slows it); the
# forced full stretches are not traced, since the profiler takes 5-30 s
# to read one such step.  The full stretches take 4 steps a forced rung
# and, to keep the script within its time limit, 4 under the gauge; the
# light forced stretches take 37 batches each, and of them only the
# exhaustive one is traced; the light gauge stretch takes 88; the loop's
# drain ingests the rest.
SERVE_STRETCHES = (("exhaustive", 0, 37, (0, 9, 18, 27), 10, True),
                   ("early_exit", 1, 37, (0, 9, 18, 27), 10, False),
                   ("reduced_k", 2, 37, (0, 9, 18, 27), 10, False),
                   ("frozen_only", 3, 37, (0, 9, 18, 27), 10, False),
                   ("gauge", None, 88, (0, 21, 42, 63, 82), 10, True),
                   ("exhaustive_full", 0, 4, range(4), FULL_BUCKET, False),
                   ("early_exit_full", 1, 4, range(4), FULL_BUCKET, False),
                   ("reduced_k_full", 2, 4, range(4), FULL_BUCKET, False),
                   ("frozen_only_full", 3, 4, range(4), FULL_BUCKET, False),
                   ("gauge_full", None, 4, range(4), FULL_BUCKET, True))


def stream_answer(bf: BruteForce, kind: str, terms, n_docs: int):
    """(docs, scores or None) of one request over the stream's first
    ``n_docs`` docs: the whole stream's answer, computed once per
    request and cut to docs below ``n_docs``.  Each kind's answer is a
    per-doc predicate in a fixed total order (docid descending; scored:
    score, then docid, descending), so the cut equals the answer over
    the prefix."""
    memo = bf.__dict__.setdefault("answers", {})
    key = (kind, tuple(terms))
    if key not in memo:
        if kind == "scored":
            memo[key] = bf.scored(terms)
        elif kind == "phrase":
            memo[key] = bf.phrase(terms[0], terms[1]), None
        elif kind == "disjunctive":
            memo[key] = bf.disjunctive(terms), None
        else:                                # conjunctive and topk
            memo[key] = bf.conjunctive(terms), None
    ids, scs = memo[key]
    m = ids < n_docs
    return ids[m], (None if scs is None else scs[m])


def rung_answer(bf: BruteForce, kind: str, terms, k: int, level: int,
                n_docs: int, base: int, cfg) -> tuple:
    """What a response served at ``level`` must equal, from the brute
    force over the stream's first ``n_docs`` docs (those applied when the
    request was dispatched); ``base`` is the frozen/active boundary
    then.  The slicing is the ladder's exactness contract."""
    kk = k if level <= serve.DEGRADE_EARLY_EXIT \
        else max(1, k // cfg.reduced_k_factor)
    full, scs = stream_answer(bf, kind, terms, n_docs)
    if kind == "scored":
        ids = full
        if level == serve.DEGRADE_FROZEN_ONLY:
            m = ids < base
            ids, scs = ids[m], scs[m]
        cut = k if level == serve.DEGRADE_NONE else kk
        return ids[:cut], scs[:cut]
    if level == serve.DEGRADE_FROZEN_ONLY:
        full = full[full < base]
    if level == serve.DEGRADE_NONE:
        return (full[:k] if kind == "topk" else full), None
    return full[:kk], None


class ServeDriver:
    """Drives a :class:`serve.ServeLoop` over an engine and an arrival
    stream, holding every response against :func:`rung_answer` at the
    docs applied when its step dispatched it, and timing the steps."""

    def __init__(self, loop, bf: BruteForce, feed, queries, pairs):
        self.loop, self.bf = loop, bf
        self.feed = list(feed)               # batches not yet acked
        self.queries, self.pairs = queries, pairs
        self.next_r = 0                      # requests submitted
        self.requests = {}                   # qid -> (kind, terms, k)
        self.rejections = []
        self.checked = 0

    def applied_docs(self) -> tuple:
        eng = self.loop.engine
        return eng.doc_base + eng.segments.active.next_docid, eng.doc_base

    def submit_ingest(self, burst: bool = False) -> None:
        """Ack the next batch (``burst``: as many as the queue takes); a
        rejection keeps the batch at the head of the feed for a retry."""
        while self.feed:
            r = self.loop.submit_ingest(self.feed[0])
            if isinstance(r, serve.Rejected):
                if r.retry_after_s <= 0:
                    raise AssertionError(f"rejection without retry-after: "
                                         f"{r}")
                self.rejections.append(r)
                return
            self.feed.pop(0)
            if not burst:
                return

    def submit_queries(self, n: int = 10) -> None:
        """Submit ``n`` requests: the kinds in turn, the next query (or
        pair, for a phrase) after each round of kinds."""
        kinds = serve.QUERY_KINDS
        for _ in range(n):
            j, self.next_r = self.next_r // len(kinds), self.next_r + 1
            kind = kinds[(self.next_r - 1) % len(kinds)]
            terms = (self.pairs[j % len(self.pairs)] if kind == "phrase"
                     else self.queries[j % len(self.queries)])
            qid = self.loop.submit_query(kind, terms, k=SERVE_K)
            if isinstance(qid, serve.Rejected):
                self.rejections.append(qid)
            else:
                self.requests[qid] = (kind, tuple(terms), SERVE_K)

    def step(self, force: bool = False, traced: bool = False):
        """One loop step; returns (its responses, ms, profile or None)."""
        n_docs, base = self.applied_docs()
        prof = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if traced:
            prof = device_profile(lambda: self.loop.step(force=force))
        else:
            self.loop.step(force=force)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out = self.loop.take_responses()
        cfg = self.loop.config
        for r in out:
            kind, terms, k = self.requests.pop(r.qid)
            ids, scs = rung_answer(self.bf, kind, terms, k, r.level,
                                   n_docs, base, cfg)
            if not np.array_equal(r.docids, ids) or (
                    scs is not None and not np.array_equal(r.scores, scs)):
                raise AssertionError(
                    f"{kind} {terms} at rung {r.level_name}: "
                    f"{len(r.docids)} docids, oracle {len(ids)}")
            if (scs is None) != (r.scores is None):
                raise AssertionError(f"{kind}: scores presence differs")
            self.checked += 1
        return out, ms, prof

    def drain(self) -> list:
        out = []
        while self.loop.pending_queries or self.loop.pending_ingest \
                or self.feed:
            if self.feed and not self.loop.pending_ingest:
                self.submit_ingest()
            out += self.step(force=True)[0]
        return out


def serve_stretch(drv: ServeDriver, name: str, level, n_batches: int,
                  query_at, n_requests: int, trace: bool,
                  burst: bool = False) -> dict:
    """One stretch of the stream under one rung (``level``) or the
    gauge (None): one arrival batch a step, ``n_requests`` requests of
    the kinds in turn at the ``query_at`` steps, the first of them
    traced if ``trace`` (and then left out of the times and latencies).
    A stretch that submits a full bucket before every step must flush a
    full bucket at every step."""
    loop = drv.loop
    loop.force_level = level
    s0 = dataclasses.replace(loop.stats,
                             served_by_level=list(loop.stats.served_by_level))
    rej0 = len(drv.rejections)
    steps, qsteps, lat, levels, prof = [], [], [], [], None
    for i in range(n_batches):
        if burst and i == 0:
            drv.submit_ingest(burst=True)
        elif not loop.pending_ingest:
            drv.submit_ingest()
        if i in query_at:
            drv.submit_queries(n_requests)
        traced = trace and i == query_at[0]
        out, ms, p = drv.step(force=traced, traced=traced)
        if traced:
            prof = p
            continue
        (qsteps if out else steps).append(ms)
        lat += [r.latency_s * 1e3 for r in out]
        levels += [r.level for r in out]
    s1 = loop.stats
    served = s1.queries_served - s0.queries_served
    full = s1.flushes_full - s0.flushes_full
    if n_requests >= loop.config.max_batch and len(query_at) == n_batches \
            and full != n_batches:
        raise AssertionError(f"serve {name}: {full} full buckets in "
                             f"{n_batches} steps")
    row = dict(
        stretch=name, served=served, requests_per_step=n_requests,
        flushes_full=full,
        flushes_timer=s1.flushes_timer - s0.flushes_timer,
        dispatches=s1.batches_dispatched - s0.batches_dispatched,
        served_per_s=len(lat) / (sum(steps + qsteps) / 1e3),
        served_by_level=[a - b for a, b in zip(s1.served_by_level,
                                               s0.served_by_level)],
        deadline_misses=s1.deadline_misses - s0.deadline_misses,
        rejections=len(drv.rejections) - rej0,
        ingest_applied=s1.ingest_applied - s0.ingest_applied,
        ms_per_step=float(np.mean(steps + qsteps)),
        ms_per_ingest_step=float(np.median(steps)) if steps else None,
        ms_per_query_step=float(np.median(qsteps)),
        query_steps=len(qsteps),
        query_step_ms=qsteps,
        latency_p50_ms=float(np.percentile(lat, 50)) if lat else None,
        latency_p99_ms=float(np.percentile(lat, 99)) if lat else None,
        traced_wall_ms=prof and prof["wall_ms"],
        traced_busy_ms=prof and prof["busy_ms"],
        traced_idle=prof and prof["idle"])
    traced = ("no step traced" if prof is None else
              f"traced step {prof['wall_ms']:.1f} ms wall, "
              f"{prof['busy_ms']:.1f} ms device "
              f"({100 * prof['idle']:.0f}% idle); top: " + top_ops(prof))
    log(f"serve {name}: {served} served (by rung {row['served_by_level']}; "
        f"{n_requests} requests at each of {len(query_at)} steps, "
        f"{full} full buckets, {row['flushes_timer']} timer flushes, "
        f"{row['dispatches']} dispatches; {row['served_per_s']:.2f} "
        f"served per s of untraced step time), "
        f"{row['deadline_misses']} deadline misses, {row['rejections']} "
        f"rejections, {row['ingest_applied']} batches applied; "
        f"{row['ms_per_step']:.1f} ms per step (ingest-only median "
        + (f"{row['ms_per_ingest_step']:.1f}" if steps else "none")
        + f", the {len(qsteps)} untraced that dispatched requests "
        f"{row['ms_per_query_step']:.1f}; each "
        + ", ".join(f"{x:.1f}" for x in qsteps)
        + f"); request latency p50 "
        f"{row['latency_p50_ms'] or 0:.1f} ms, p99 "
        f"{row['latency_p99_ms'] or 0:.1f} ms (untraced steps); " + traced)
    return row


def checked_routes() -> int:
    """The sanitized routes (``checked=True``) on the card: each of the
    five launches its kernel once, counted, and equals the unchecked
    call; an out-of-range input raises ``SanitizerError`` before any
    launch.  Returns the number of checked calls."""
    from repro_torch.analysis import sanitize
    rng = np.random.default_rng(21)
    ids = [np.unique(rng.integers(0, 1 << 20, n)).astype(np.uint32)
           for n in (4000, 900)]
    A, B = (pack_docids(x).to("cuda") for x in ids)
    SA = stack_packed([pack_docids(x) for x in ids]).to("cuda")
    SB = stack_packed([pack_docids(x) for x in ids[::-1]]).to("cuda")
    sc = [si.pack_scored(x, rng.integers(1, 256, x.size)) for x in ids]
    SCA, SCB = stack_scored(sc).to("cuda"), stack_scored(sc[::-1]).to("cuda")
    rest = torch.full((2,), 255, dtype=torch.int32, device="cuda")
    th = torch.full((2,), -1, dtype=torch.int32, device="cuda")
    la = torch.full((2, 4096), 0xFFFFFFFF, dtype=torch.int64, device="cuda")
    lb = la.clone()
    for r, x in enumerate(ids):
        la[r, :x.size] = torch.as_tensor(x.astype(np.int64))
        lb[1 - r, :x.size] = torch.as_tensor(x.astype(np.int64))
    H, V = 1 << 16, 4096                  # one lane per term, as a plan
    perm = torch.as_tensor(rng.permutation(H), device="cuda")

    def i64(x):
        return torch.as_tensor(x, dtype=torch.int64, device="cuda")

    dense = (torch.zeros(H, dtype=torch.int64, device="cuda"),
             i64(np.full(V, 0xFFFFFFFF)),
             torch.zeros(V, dtype=torch.int32, device="cuda"),
             perm[:V].clone(), i64(rng.integers(1, 1 << 20, V)),
             perm[V: 2 * V].clone(), i64(rng.integers(0, H, V)),
             i64(rng.permutation(V)), i64(rng.integers(0, H, V)),
             torch.ones(V, dtype=torch.int32, device="cuda"))
    far = lambda p: p._replace(woffs=p.woffs + 10_000)  # noqa: E731
    cases = (("intersect_mask", (la, lb), (la, lb[:1])),
             ("segment_intersect_mask", (A, B), (far(A), B)),
             ("segment_intersect_mask_batched", (SA, SB), (far(SA), SB)),
             ("scored_intersect_batched", (SCA, SCB, rest, th),
              (SCA._replace(ids=far(SCA.ids)), SCB, rest, th)),
             ("bulk_append", dense,
              dense[:5] + (dense[5] + H,) + dense[6:]))
    for name, good, bad in cases:
        fn = getattr(ops, name)
        # bulk_append writes its first three arguments in place
        fresh = [t.clone() if name == "bulk_append" and i < 3 else t
                 for i, t in enumerate(good)]
        want = fn(*fresh)
        ops.reset_launch_counts()
        got = fn(*[t.clone() if name == "bulk_append" and i < 3 else t
                   for i, t in enumerate(good)], checked=True)
        if ops.launch_counts()[name] != 1:
            raise AssertionError(f"checked {name} launched "
                                 f"{ops.launch_counts()[name]} kernels")
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if not torch.equal(g, w):
                raise AssertionError(f"checked {name} differs from the "
                                     f"unchecked call")
        try:
            fn(*bad, checked=True)
        except sanitize.SanitizerError:
            pass
        else:
            raise AssertionError(f"checked {name} let a bad input through")
        if ops.launch_counts()[name] != 1:
            raise AssertionError(f"checked {name} launched on a bad input")
    return len(cases)


def phase_serve(eng, docs: np.ndarray, vocab: int, seed: int,
                tmp: str) -> dict:
    """7(a): phase 3's full-width engine behind the reference's
    ``ServeConfig`` with a journal; 2**20 more tweets in 4096-tweet
    batches interleaved with requests of every kind, each rung forced in
    turn, then a stretch under the gauge (with a burst that meets the
    ingest queue's backpressure), first at a light request rate, then
    with a full 32-request bucket before every step
    (``SERVE_STRETCHES``).  Every response is held against the
    brute force over the docs applied before its dispatch; every acked
    batch is read back from the journal; ``check_serve`` and
    ``check_engine`` run on the final state."""
    n0 = docs.shape[0]
    if eng.doc_base + eng.segments.active.next_docid != n0:
        raise AssertionError("the engine has not ingested the stream")
    t0 = time.perf_counter()
    more = make_stream(vocab, SERVE_DOCS, seed=seed)
    stream = np.concatenate([docs, more])
    queries, pairs = query_batch(docs, vocab, 24, seed=seed + 1)
    bf = BruteForce(stream, {t for q in queries for t in q}, vocab)
    log(f"serve: {SERVE_DOCS} more tweets and the oracle over "
        f"{stream.shape[0]} in {time.perf_counter() - t0:.1f} s")
    cfg = serve.ServeConfig()
    wal = os.path.join(tmp, "serve.jrnl")
    journal = recovery.IngestJournal(wal)
    loop = serve.ServeLoop(eng, cfg, journal=journal)
    batches = [more[s: s + BATCH] for s in range(0, SERVE_DOCS, BATCH)]
    drv = ServeDriver(loop, bf, batches, queries, pairs)
    ops.reset_launch_counts()
    rows = []
    t0 = time.perf_counter()
    for name, level, n_b, q_at, n_rq, trace in SERVE_STRETCHES:
        rows.append(serve_stretch(drv, name, level, n_b, q_at, n_rq, trace,
                                  burst=name == "gauge"))
    drv.drain()
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    counts = ops.launch_counts()
    for k in ("bulk_append", "segment_intersect_mask_batched",
              "scored_intersect_batched"):
        if counts[k] <= 0:
            raise AssertionError(f"the serving path never launched {k}")
    if not next(r for r in rows if r["stretch"] == "gauge")["rejections"]:
        raise AssertionError("the burst met no ingest backpressure")
    journal.close()
    _, records = recovery.read_journal(wal)
    if len(records) != len(batches) or not all(
            np.array_equal(d, b) for (_, d), b in zip(records, batches)):
        raise AssertionError("the journal does not hold every acked batch")
    if (eng.doc_base + eng.segments.active.next_docid != stream.shape[0]
            or loop.stats.ingest_applied != len(batches)):
        raise AssertionError("an acked batch was not applied")
    os.remove(wal)
    t0 = time.perf_counter()
    rep_serve = invariants.check_serve(loop)
    t_cs = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep_eng = invariants.check_engine(eng)
    torch.cuda.synchronize()
    t_ce = time.perf_counter() - t0
    rep_serve.raise_if_failed()
    rep_eng.raise_if_failed()
    st = loop.stats
    log(f"serve: {drv.checked} responses held against the brute force at "
        f"their rungs; {st.queries_served} served, {st.deadline_misses} "
        f"deadline misses, {st.queries_rejected} query and "
        f"{st.ingest_rejected} ingest rejections (each with retry-after), "
        f"{st.ingest_applied} acked batches applied and read back from "
        f"the journal, {st.batches_dispatched} dispatches "
        f"({st.flushes_full} full, {st.flushes_timer} by the timer) in "
        f"{t_serve:.1f} s; serving-path launches {json.dumps(counts)}")
    log(f"serve: check_serve ok={rep_serve.ok} in {t_cs:.4f} s "
        f"{rep_serve.stats}; check_engine on the full-width state ok="
        f"{rep_eng.ok} in {t_ce:.2f} s {rep_eng.stats}")
    return dict(stretches=rows, responses_checked=drv.checked,
                serve_s=t_serve, launches=counts,
                check_serve_s=t_cs, check_engine_s=t_ce,
                check_engine_stats=rep_eng.stats,
                stats=dataclasses.asdict(st))


def phase_serve_crash(tmp: str) -> dict:
    """7(b): at phase 4's depth (2**16-tweet segments) a journaled,
    ``validate=True`` engine behind the loop dies inside a rollover
    (``faults.crash_site("crash_mid_rollover")``) with requests in
    flight; ``recover`` on the card and ``resume_with``; the stream goes
    on.  Every acked batch is read back, the fingerprint equals an
    uncrashed engine's, every response equals the brute force; then
    every ``FaultPlan`` kind at the harness's sizes on the card."""
    small = 1 << 16
    vocab = 1 << 16
    sdocs = make_stream(vocab, 4 * small + small // 2, seed=13)
    layout, _, fmax = size_layout(sdocs, vocab, small)

    def engine():
        return LifecycleEngine(
            layout, vocab, small,
            max_slices=int(analytical.slices_needed(Z, fmax)) + 1,
            max_len=1 << int(fmax - 1).bit_length(),
            compaction=CompactionPolicy(fanout=2), validate=True,
            device="cuda")

    queries, pairs = query_batch(sdocs, vocab, 12, seed=14)
    bf = BruteForce(sdocs, {t for q in queries for t in q}, vocab)
    batches = [sdocs[s: s + BATCH] for s in range(0, sdocs.shape[0], BATCH)]
    wal, snap = os.path.join(tmp, "crash.jrnl"), os.path.join(tmp,
                                                              "crash.snap")
    journal = recovery.IngestJournal(wal)
    loop = serve.ServeLoop(engine(), serve.ServeConfig(), journal=journal)
    loop.force_level = serve.DEGRADE_NONE
    drv = ServeDriver(loop, bf, batches, queries, pairs)
    loop.snapshot_now(snap)
    per_seg = small // BATCH
    arm = 5 * per_seg // 2                  # mid third segment
    crashed_at = None
    for i in range(len(batches)):
        drv.submit_ingest()
        fills = (i + 1) % per_seg == 0      # this step's batch rolls over
        if i % (per_seg // 2) == 0 or fills:
            drv.submit_queries(n=5)
        if i == per_seg + per_seg // 4:
            drv.step()
            loop.snapshot_now(snap)         # a mid-stream snapshot
            continue
        if i < arm:
            drv.step(force=fills)
            continue
        try:
            with faults.crash_site("crash_mid_rollover"):
                drv.step(force=fills)       # requests in flight
        except faults.InjectedCrash:
            crashed_at = i
            break
    acked, in_flight = journal.next_seq, loop.in_flight_queries
    if crashed_at is None or not in_flight:
        raise AssertionError("the injected crash never fired with "
                             "requests in flight")
    journal.close()
    torn = loop.engine
    loop.engine = None
    del torn
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = recovery.recover(snap, wal, expect_seq=acked, device="cuda")
    torch.cuda.synchronize()
    t_rec = time.perf_counter() - t0
    loop.resume_with(rec, journal=recovery.IngestJournal(wal))
    drv.drain()
    loop.journal.close()
    _, records = recovery.read_journal(wal)
    if len(records) != len(batches) or not all(
            np.array_equal(d, b) for (_, d), b in zip(records, batches)):
        raise AssertionError("an acked batch is missing from the journal")
    oracle = engine()
    for b in batches:
        oracle.ingest(b)
    fa = recovery.engine_fingerprint(loop.engine)
    fb = recovery.engine_fingerprint(oracle)
    fa.pop("stats"), fb.pop("stats")     # scored requests bump the stats
    if fa != fb:
        raise AssertionError("the recovered, resumed engine differs from "
                             "the uncrashed one")
    invariants.check_serve(loop).raise_if_failed()
    st = loop.stats
    log(f"serve crash: died inside the rollover at batch {crashed_at} of "
        f"{len(batches)} with {in_flight} requests in flight; recovered "
        f"on the card in {t_rec:.2f} s ({acked} acked batches, "
        f"{st.ingest_recovered} of them queued at the crash), resumed: "
        f"fingerprint equal to the uncrashed engine's, every acked batch "
        f"read back, {drv.checked} responses equal to the brute force, "
        f"{st.queries_aborted} aborted in flight; check_serve ok")
    del loop, rec, oracle
    torch.cuda.empty_cache()
    kinds = {}
    for kind in faults.KINDS:
        res = faults.run_plan(faults.FaultPlan(kind=kind, seed=3), tmp,
                              device="cuda")
        kinds[kind] = ("raised" if res.raised is not None else
                       f"recovered (crashed={res.crashed})")
    faults.run_plan(faults.FaultPlan(kind="crash_mid_rollover", seed=0,
                                     validate=True), tmp, device="cuda")
    log(f"fault plans on the card: {json.dumps(kinds)}; and a validate=True "
        f"crash_mid_rollover plan")
    return dict(crashed_at=crashed_at, acked=acked, recover_s=t_rec,
                responses_checked=drv.checked, fault_plans=kinds)


def sp_pool_need(freqs: np.ndarray, start: np.ndarray) -> np.ndarray:
    """Slices each pool gives a segment whose term ``t`` occurs
    ``freqs[t]`` times and starts in pool ``start[t]``: the chain's slice
    i lives in pool min(start + i, P - 1); a chain starting past pool 0
    loses one slot of its first slice to the NULL pointer
    (``analytical.memory_slots_sp``'s model)."""
    P = len(Z)
    need = np.zeros(P, np.int64)
    live = freqs > 0
    f, s = freqs[live].astype(np.int64), start[live].astype(np.int64)
    for sp in np.unique(s):
        fm = f[s == sp]
        if sp == 0:
            n_sl = analytical.slices_needed(Z, fm)
        else:
            zs = Z[int(sp):]
            last = (1 << zs[-1]) - 1
            th = analytical.thetas(zs, len(zs) + int(fm.max()) // last + 2)
            n_sl = np.searchsorted(th - 1, np.maximum(fm, 1)) + 1
        for p in range(int(sp), P):
            i = p - int(sp)
            need[p] += int((np.clip(n_sl - i, 0, None) if p == P - 1
                            else n_sl > i).sum())
    return need


def phase_table2(hist: np.ndarray, vocab: int, seg_docs: int,
                 seed: int) -> dict:
    """7(c): the paper's Table 2 at full width.  The history H is phase
    3's frozen segment's term frequencies; a fresh 2**23-tweet stream
    from a new seed (over phase 3's dictionary, :func:`next_stream`) is
    indexed into one segment under each SP policy,
    its pools sized from the policy's own start table.  Per policy: the
    live and high-water slots, the waste against SP(z0), the overflow
    flag (must be 0), and the slots (and each pool's slices) against
    ``analytical.memory_slots_sp`` over the stream's frequencies."""
    t0 = time.perf_counter()
    docs = next_stream(vocab, seg_docs, seed=seed, dict_seed=0)
    freqs = synth.term_freqs(docs, vocab)
    ch = history.churn(hist, freqs, top_k=10000)
    log(f"table 2: a fresh {seg_docs}-tweet stream (seed {seed}) in "
        f"{time.perf_counter() - t0:.1f} s; churn of the top 10,000 terms "
        f"against the history {ch:.4f}")
    cap = pointers.production_layout().max_slices
    live = freqs > 0
    rows = {}
    for policy in sorted(policies.POLICIES):
        table = policies.start_pools_for_vocab(policy, Z, hist,
                                               device="cuda")
        start = table.cpu().numpy()
        need = sp_pool_need(freqs, start)
        spp = tuple(min(1 << int(np.ceil(np.log2(max(n * 1.25, 2)))),
                        cap(p)) for p, n in enumerate(need))
        layout = pointers.production_layout(spp)
        seg = ActiveSegment(layout, vocab, max_docs=seg_docs, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(0, seg_docs, BATCH):
            seg.ingest(docs[s: s + BATCH], term_start_pools=table)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        used = seg.memory_slots_used()
        hw = slicepool.memory_high_water_slots(layout, seg.state)
        overflow = int(bool(seg.state.overflow))
        model = int(analytical.memory_slots_sp(Z, freqs[live],
                                               start[live]).sum())
        wm = seg.state.watermark.cpu().numpy().astype(np.int64)
        if overflow or used != model or not np.array_equal(wm, need):
            raise AssertionError(
                f"{policy}: overflow {overflow}, slots {used} vs model "
                f"{model}, slices per pool {wm.tolist()} vs "
                f"{need.tolist()}")
        rows[policy] = dict(slots=used, high_water=hw, overflow=overflow,
                            model_slots=model, slices=wm.tolist(),
                            pools=list(spp), docs_per_s=seg_docs / dt)
        del seg
        torch.cuda.empty_cache()
    base = rows["sp_default"]["slots"]
    for policy, r in rows.items():
        r["waste_vs_default"] = (r["slots"] - base) / base
        log(f"table 2 {policy}: {r['slots']} slots live, high-water "
            f"{r['high_water']}, waste against SP(z0) "
            f"{100 * r['waste_vs_default']:+.2f}%, overflow "
            f"{r['overflow']}, = the model's {r['model_slots']}; slices "
            f"per pool {r['slices']} of {r['pools']}; "
            f"{r['docs_per_s']:.0f} docs/s")
    return dict(churn_top10k=ch, policies=rows)



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


def phase_paged(seed: int, requests: int = 33, max_seqs: int = 32,
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


def index_stream(segment_log2: int):
    """The main path's tweet stream and pools: ``(docs, layout, vocab,
    seg_docs, extra, fmax)``."""
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
    return docs, layout, vocab, seg_docs, extra, fmax


@contextlib.contextmanager
def capturing(store: dict, *names):
    """Route each ``ops.<name>`` through a spy that keeps every call's
    inputs on the host (``tsg.to_host``) in ``store[name]`` and launches
    once."""
    reals = {n: getattr(ops, n) for n in names}

    def spy(name):
        def call(*args):
            store.setdefault(name, []).append([tsg.to_host(a) for a in args])
            return reals[name](*args)
        return call
    for n in names:
        setattr(ops, n, spy(n))
    try:
        yield store
    finally:
        for n, fn in reals.items():
            setattr(ops, n, fn)


def save_segment_calls(path: str, segment_log2: int) -> None:
    """``--segment-calls``: phase 3 (the main path at full width) and
    phase 4 with the frozen-segment kernels' inputs captured: the main
    path's ``segment_intersect_mask_batched`` and
    ``scored_intersect_batched`` calls (the ones its launch counts
    count; the traced batches after them are left out) and the
    sequential route's ``segment_intersect_mask`` calls, saved to
    ``path`` for ``launch/time_segment_intersect.py --calls``."""
    docs, layout, vocab, seg_docs, extra, fmax = index_stream(segment_log2)
    calls = {}
    main_k = ("segment_intersect_mask_batched", "scored_intersect_batched")
    with capturing(calls, *main_k):
        main_sum = phase_main(docs, layout, vocab, seg_docs, extra, 8,
                              n_queries=64, fmax=fmax)
    for k in main_k:
        calls[k] = calls.get(k, [])[: main_sum["launches"][k]]
    del docs
    seq = {}
    with capturing(seq, "segment_intersect_mask"):
        counts = phase_small()
    calls["segment_intersect_mask"] = seq.get("segment_intersect_mask", [])
    for k, v in calls.items():
        want = (main_sum["launches"] if k in main_k else counts)[k]
        if len(v) != want or not v:
            raise AssertionError(f"{k}: {len(v)} calls captured, {want} "
                                 f"launches counted")
    size = tsg.save_calls(path, calls)
    log(f"saved {', '.join(f'{len(v)} {k}' for k, v in calls.items())} "
        f"calls to {path} ({size / 2**20:.1f} MiB)")


def phase_index(segment_log2: int, serve_only: bool = False):
    """Phases 2-4, 7 and 8 (the streaming index, search serving and the
    sharded index) around one full-width stream: phase 3's engine goes
    on to serve (7a), its history drives Table 2 (7c), phase 4 and the
    crash under serve (7b) run at 2**16-tweet segments, then the stream
    and phase 3's brute force serve the sharded engine (8).  Returns
    the kernel rows (none with ``serve_only``, which leaves out phases
    2, 4 and 8)."""
    docs, layout, vocab, seg_docs, extra, fmax = index_stream(segment_log2)
    q_rows = 8
    if not serve_only:
        kernels = phase_kernels(docs, layout, vocab, seg_docs, q_rows,
                                seed=5)
    main_sum, eng = phase_main(docs, layout, vocab, seg_docs, extra, q_rows,
                               n_queries=MAIN_QUERIES, fmax=fmax, keep=True)
    oracle = main_sum.pop("oracle")
    t0 = time.perf_counter()
    n = checked_routes()
    log(f"checked routes on the card: {n} kernels, each launched once "
        f"by its checked call and equal to the unchecked one; an "
        f"out-of-range input raised SanitizerError before any launch")
    with tempfile.TemporaryDirectory() as tmp:
        serve_sum = phase_serve(eng, docs, vocab, seed=11, tmp=tmp)
    hist = eng.segments.history_freqs()
    del eng
    torch.cuda.empty_cache()
    log(f"phase 7a (serving at full width) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    table2 = phase_table2(hist, vocab, seg_docs, seed=12)
    log(f"phase 7c (Table 2) {time.perf_counter() - t0:.1f} s")
    if not serve_only:
        seq_counts = phase_small()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        crash = phase_serve_crash(tmp)
    log(f"phase 7b (crash under serve) {time.perf_counter() - t0:.1f} s")
    log("search serving: " + json.dumps(dict(
        serve=serve_sum, table2=table2, crash=crash)))
    log("main path: " + json.dumps({
        k: v for k, v in main_sum.items() if k != "launches"}))
    if serve_only:
        return []
    sharded = phases_sharded(docs, vocab, seg_docs, extra, q_rows, oracle)
    del docs

    table = []
    for name in ("bulk_append", "segment_intersect_mask_batched",
                 "intersect_mask", "segment_intersect_mask",
                 "scored_intersect_batched"):
        r = kernels[name]
        on_main = name in ("bulk_append", "segment_intersect_mask_batched",
                           "scored_intersect_batched")
        paths = ({"main": main_sum["launches"][name]} if on_main
                 else {"sequential": seq_counts[name]})
        if name != "segment_intersect_mask":
            paths["sharded"] = sharded["launches"][name]
            paths["ranks"] = sharded["ranks"]["launches"][name]
            paths["ranks_serve"] = sum(
                n[name] for n in sharded["ranks"]["gloo"]["serving"][
                    "launches"])
        paths["ranks_nccl"] = sharded["ranks"]["nccl1"]["launches"][name]
        row = dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=sum(paths.values()),
            path="+".join(paths), launches_by_path=paths,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by="bytes",
            library_ms=r["library_ms"])
        if name == "intersect_mask":
            row["sharded_calls"] = {k: sharded["intersect_mask"][k] for k in (
                "calls", "seq_device_ms", "seq_bound_ms", "max_abs_err",
                "ms", "ms_cold", "device_ms", "plain_ms", "library_ms",
                "bound_ms")}
        table.append(row)
    return table


def phases_sharded(docs, vocab: int, seg_docs: int, extra: int,
                   q_rows: int, oracle=None) -> dict:
    """Phase 8: (a) four stacked shards at a sixteenth of the segment
    (the stream's first 2**19 + 2**16 tweets, a brute force of its own),
    (b)
    at phase 4's depth, in this process while (c) the index on ranks
    runs at full width in its own processes (``oracle``:
    phase 3's queries, pairs and answers, of which the first
    :data:`RANK_QUERIES` are used; made here when None); logs and returns
    8(a)'s summary with 8(c)'s under ``ranks``."""
    t0 = time.perf_counter()
    seg_a, extra_a = seg_docs >> SHARDED_SHIFT, extra >> SHARDED_SHIFT
    full = phase_sharded(docs[: seg_a + extra_a + BATCH], vocab, seg_a,
                         extra_a, q_rows, SHARDED_QUERIES)
    log(f"phase 8a (sharded, {seg_a}-tweet segments) "
        f"{time.perf_counter() - t0:.1f} s")
    small = {}

    def phase_8b():
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            small.update(phase_sharded_small(tmp))
        log(f"phase 8b (sharded, phase 4 depth, beside 8c's ranks) "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    if oracle is None:
        oracle = rank_oracle(docs, vocab, seg_docs + extra)
    queries, pairs, want = oracle
    n = RANK_QUERIES
    full["ranks"] = phase_ranks(docs, vocab, seg_docs, extra, (
        queries[:n], pairs[:n], {k: v[:n] for k, v in want.items()}),
        beside=phase_8b)
    log(f"phases 8b and 8c (ranks) {time.perf_counter() - t0:.1f} s")
    log("sharded: " + json.dumps(dict(
        {k: v for k, v in full.items() if k != "launches"}, small=small,
        launches=full["launches"])))
    return full


# ---------------------------------------------------------------------------
# phase 8: the document-sharded index, four shards stacked on the card
# ---------------------------------------------------------------------------
SHARDS = 4                    # S: docid d lives on shard d % S
SHARDED_QUERIES = 8           # 8a's queries of each kind, one batch
SHARDED_SHIFT = 4             # 8a's segment: Earlybird's 2**23 tweets >> 4
                              # (8c runs the full width on ranks): depth
                              # cuts that keep the script within its time
                              # limit


def shard_layout(docs: np.ndarray, vocab: int, seg_docs: int,
                 n_shards: int = SHARDS):
    """Pools sized by :func:`size_layout` from each shard's own
    residue-class substream ``docs[s::S]`` (segments of ``seg_docs / S``
    local docs); one layout serves every shard, so each pool takes the
    largest shard's size.  Returns ``(layout, need, fmax)`` with the
    largest shard's per-pool need and per-shard head-term frequency."""
    per = [size_layout(docs[s::n_shards], vocab, seg_docs // n_shards)
           for s in range(n_shards)]
    spp = tuple(max(lay.slices_per_pool[p] for lay, _, _ in per)
                for p in range(len(Z)))
    need = np.max([n for _, n, _ in per], axis=0)
    return (pointers.production_layout(spp), need,
            max(f for _, _, f in per))


def sharded_engine(layout, vocab: int, seg_docs: int, fmax: int, **kw):
    return ShardedLifecycleEngine(
        layout, vocab, seg_docs, make_doc_mesh(SHARDS, device="cuda"),
        max_slices=int(analytical.slices_needed(Z, fmax)) + 1,
        max_len=engine_max_len(fmax), device="cuda", **kw)


def _prefix_rows(x):
    """An ascending INVALID-padded list tensor as its rows' valid
    prefixes (int32 values, int64 lengths) and its shape; raises if a
    row's valid entries are not a prefix."""
    valid = x != INVALID
    n = valid.sum(-1)
    lane = torch.arange(x.shape[-1], device=x.device)
    if not torch.equal(valid, lane < n[..., None]):
        raise AssertionError("an intersect_mask input row is not an "
                             "INVALID-padded prefix")
    return x[valid].to(torch.int32), n, tuple(x.shape)


def _unprefix(vals, n, shape):
    out = torch.full(shape, INVALID, dtype=torch.int64, device=vals.device)
    lane = torch.arange(shape[-1], device=vals.device)
    out[lane < n[..., None]] = vals.long()
    return out


@contextlib.contextmanager
def keeping_intersect_calls(calls: list):
    """Route ``ops.intersect_mask`` through a spy that appends each
    call's inputs to ``calls`` as valid prefixes (:func:`_prefix_rows`)
    and launches the kernel as before (its launch count unchanged)."""
    real = ops.intersect_mask

    def spy(a, b):
        calls.append((_prefix_rows(a), _prefix_rows(b)))
        return real(a, b)
    ops.intersect_mask = spy
    try:
        yield calls
    finally:
        ops.intersect_mask = real


def replay_intersect_calls(calls, what: str) -> float:
    """Each kept ``intersect_mask`` call rebuilt at its padded shape and
    launched twice, bit-equal to ``intersect_mask_ref`` (raises if not);
    returns the max abs error (0)."""
    err = 0
    for i, (pa, pb) in enumerate(calls):
        a, b = _unprefix(*pa), _unprefix(*pb)
        want = ref.intersect_mask_ref(a, b)
        for k in range(2):
            err = max(err, require_equal(
                f"intersect_mask {what} call {i} (replay {k})",
                ops.intersect_mask(a, b), want))
    return err


def sharded_intersect_calls(calls, flush) -> dict:
    """The sharded route's own ``intersect_mask`` calls (kept as valid
    prefixes, rebuilt at their padded shapes): each twice on the card,
    bit-equal to ``intersect_mask_ref``; the whole sequence under the
    profiler beside its summed byte bound; and the call that needs the
    most bytes warm, L2-flushed, by the profiler, beside its plain
    version, ``searchsorted`` + ``gather`` and its bound."""
    err = replay_intersect_calls(calls, "sharded")
    need, top = 0, None
    for i, (pa, pb) in enumerate(calls):
        nb = tim.bound_bytes(_unprefix(*pa), _unprefix(*pb))[0]
        need += nb
        if top is None or nb > top[0]:
            top = (nb, i)

    def replay():
        for pa, pb in calls:
            ops.intersect_mask(_unprefix(*pa), _unprefix(*pb))
    seq_ms, seen = profiled_total_ms(replay, "intersect_mask")
    if seen != len(calls):
        raise AssertionError(f"profiler saw {seen} intersect_mask kernels "
                             f"for {len(calls)} calls")
    a, b = (_unprefix(*p) for p in calls[top[1]])
    W = b.shape[-1]

    def call():
        return ops.intersect_mask(a, b)

    def library():
        pos = torch.searchsorted(b, a).clamp_(max=W - 1)
        return torch.gather(b, -1, pos) == a
    r = dict(calls=len(calls), max_abs_err=err, seq_device_ms=seq_ms,
             seq_bound_ms=need / HBM_BYTES_PER_S * 1e3, seq_bytes=need,
             ms=cuda_ms(call), ms_cold=cuda_ms_cold(call, flush),
             device_ms=profiled_ms(call, "intersect_mask")[0],
             plain_ms=cuda_ms(lambda: ref.intersect_mask_ref(a, b)),
             library_ms=cuda_ms(library), bytes=top[0],
             bound_ms=top[0] / HBM_BYTES_PER_S * 1e3,
             shape=f"a {tuple(a.shape)} ({int((a != INVALID).sum())} "
                   f"valid), b {tuple(b.shape)} "
                   f"({int((b != INVALID).sum())} valid)")
    log(f"sharded intersect_mask: {len(calls)} calls of the sharded route "
        f"replayed twice, bit-equal to the plain version; the sequence "
        f"{seq_ms:.4f} ms by the profiler ({seq_ms / len(calls):.4f} ms "
        f"each) against its bound {r['seq_bound_ms']:.4f} ms ({need} "
        f"bytes); its largest call, {r['shape']}: {r['ms']:.4f} ms warm, "
        f"{r['ms_cold']:.4f} L2-flushed, "
        + ("profiler not measured" if r["device_ms"] is None else
           f"{r['device_ms']:.4f} by the profiler")
        + f"; plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} "
        f"ms, bound {r['bound_ms']:.4f} ms ({top[0]} bytes)")
    return r


def phase_sharded(docs: np.ndarray, vocab: int, seg_docs: int,
                  extra_docs: int, q_rows: int, n_queries: int) -> dict:
    """8(a): a prefix of phase 3's stream through a four-shard
    ``ShardedLifecycleEngine`` over ``make_doc_mesh(4)`` at ``seg_docs``
    tweets a segment, one rollover, ``extra_docs`` more tweets, then the
    query batches of every kind held against a brute force of its
    own."""
    t0 = time.perf_counter()
    layout, need, fmax = shard_layout(docs, vocab, seg_docs)
    log(f"sharded: {SHARDS} shards of {seg_docs // SHARDS} local docs a "
        f"segment; pools {layout.slices_per_pool} slices a shard for the "
        f"largest shard's analytic need {tuple(int(x) for x in need)} "
        f"({layout.total_slots} slots a shard); shard head-term freq "
        f"{fmax}, per-shard max_len {engine_max_len(fmax)}; sized in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = sharded_engine(layout, vocab, seg_docs, fmax)
    total = seg_docs + extra_docs
    ops.reset_launch_counts()
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
            hw_roll = eng.stats.high_water_slots
    torch.cuda.synchronize()
    t_after = time.perf_counter() - t0 - t_first - t_roll
    eng.check_health()
    if eng.stats.rollovers != 1:
        raise AssertionError(f"expected one rollover, saw "
                             f"{eng.stats.rollovers}")
    ingest_counts = ops.launch_counts()
    n_batches = total // BATCH
    if ingest_counts["bulk_append"] != SHARDS * n_batches:
        raise AssertionError(f"bulk_append launched "
                             f"{ingest_counts['bulk_append']} times for "
                             f"{n_batches} batches of {SHARDS} shards")
    st = eng.segments.active.state
    sizes = np.asarray(layout.slice_sizes, np.int64)
    shard_live = slicepool.shard_slots_used(layout, st)
    shard_hw = (st.watermark.cpu().numpy().astype(np.int64)
                * sizes).sum(1)
    log(f"sharded ingest: {seg_docs - BATCH} docs in {t_first:.3f} s = "
        f"{(seg_docs - BATCH) / t_first:.0f} docs/s ({SHARDS} bulk_append "
        f"launches and {SHARDS} plan host syncs a batch); the batch that "
        f"filled the segment + rollover (4 freezes, reclaim) {t_roll:.3f} "
        f"s; {extra_docs} docs into recycled slices in {t_after:.3f} s = "
        f"{extra_docs / t_after:.0f} docs/s")
    log(f"sharded pools: high-water {hw_roll} slots at rollover, "
        f"{eng.memory_high_water_slots()} after; live "
        f"{eng.memory_slots_used()}; per shard live "
        f"{shard_live.tolist()}, high-water {shard_hw.tolist()}")
    t0 = time.perf_counter()
    queries, pairs, want = rank_oracle(docs, vocab, total, n_queries)
    log(f"sharded: brute force of its own in "
        f"{time.perf_counter() - t0:.1f} s")
    with keeping_intersect_calls([]) as calls:
        res = run_queries(eng, queries, pairs, q_rows)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = max([torch.cuda.max_memory_allocated()]
               + [r[2] for r in res.values()])
    for kind, (_, times, kpeak) in res.items():
        log(f"sharded query {kind}: {len(times)} batches of {q_rows}: "
            f"{', '.join(f'{t:.1f}' for t in times)} ms; median "
            f"{np.median(times):.1f} ms; peak device memory "
            f"{kpeak / 2**30:.2f} GiB")
    log(f"sharded-path launches: {json.dumps(counts)}; peak device memory "
        f"{peak / 2**30:.2f} GiB ({peak} bytes)")
    for k in ("intersect_mask", "segment_intersect_mask_batched",
              "scored_intersect_batched"):
        if counts[k] <= 0:
            raise AssertionError(f"sharded path never launched {k}")
    if len(calls) != counts["intersect_mask"]:
        raise AssertionError(f"{len(calls)} intersect_mask calls seen, "
                             f"{counts['intersect_mask']} launches counted")
    for kind, (got, _, _) in res.items():
        check_answers(f"sharded {kind}", got, want[kind])
    log(f"sharded brute force: {len(queries)} queries of each kind agree "
        f"with the brute force")
    # the ingest batch alone: a traced query batch costs the profiler
    # seconds to read, and 8c runs the queries at full width
    prof = profile_paths(eng, docs[total: total + BATCH], [], [], q_rows)
    del eng, st
    torch.cuda.empty_cache()
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    im = sharded_intersect_calls(calls, flush)
    log(f"sharded intersect_mask replay and timing "
        f"{time.perf_counter() - t0:.1f} s")
    del calls, flush
    torch.cuda.empty_cache()
    return dict(
        ingest_docs_per_s=(seg_docs - BATCH) / t_first,
        recycled_docs_per_s=extra_docs / t_after, rollover_s=t_roll,
        query_ms={k: float(np.median(v[1])) for k, v in res.items()},
        query_peak_bytes={k: v[2] for k, v in res.items()},
        peak_bytes=peak, high_water_slots_at_rollover=hw_roll,
        shard_live_slots=shard_live.tolist(),
        shard_high_water_slots=shard_hw.tolist(),
        profile=prof,
        launches=dict(counts, bulk_append=ingest_counts["bulk_append"]),
        intersect_mask=im)


def _sym_batches(n: int, V: int = 64) -> list:
    """Batches that split term for term across four shards."""
    return [np.arange(d, d + V, dtype=np.int32).reshape(V, 1) % V
            for d in range(0, n * V, V)]


def sharded_serving() -> dict:
    """The reference's sharded serving case on the card: per-shard pools
    a quarter of a single-device engine's over a stream that splits term
    for term across shards, so emergency rollovers and engine sheds
    agree batch for batch with the single-device engine; the ServeLoop
    over the sharded engine reaches an emergency rollover, answers at
    rungs 0 and 3 like the single-device engine, rejects an ingest batch
    with a retry-after under pool pressure and takes it after a
    rollover; ``check_serve`` and ``check_engine`` on the final state."""
    def mk(adm, sharded):
        if sharded:
            return ShardedLifecycleEngine(
                pointers.PoolLayout(z=Z, slices_per_pool=(64, 24, 6, 2)),
                128, 100_000, make_doc_mesh(SHARDS, device="cuda"),
                max_slices=64, max_len=64, admission=adm, device="cuda")
        return LifecycleEngine(
            pointers.PoolLayout(z=Z, slices_per_pool=(256, 96, 24, 8)),
            128, 100_000, max_slices=64, max_len=64, admission=adm,
            device="cuda")
    batches = _sym_batches(30)
    e1 = mk(AdmissionController(rollover_at=0.6), False)
    e4 = mk(AdmissionController(rollover_at=0.6), True)
    loop = serve.ServeLoop(e4, serve.ServeConfig(default_k=8))
    for docs in batches:
        if not e1.ingest(docs):
            raise AssertionError("the single-device engine shed a batch")
        if not isinstance(loop.submit_ingest(docs), int):
            raise AssertionError("the loop rejected a batch below its "
                                 "pool-pressure limit")
        loop.step(force=True)
    if not e1.stats.emergency_rollovers == e4.stats.emergency_rollovers > 0:
        raise AssertionError(
            f"emergency rollovers: single {e1.stats.emergency_rollovers}, "
            f"sharded {e4.stats.emergency_rollovers}")
    for level in (serve.DEGRADE_NONE, serve.DEGRADE_FROZEN_ONLY):
        loop.force_level = level
        loop.submit_query("conjunctive", (3, 7), k=8)
        loop.step(force=True)
        (r,) = loop.take_responses()
        full = e1.conjunctive([3, 7])
        if level == serve.DEGRADE_FROZEN_ONLY:
            full = full[full < e4.doc_base][:2]
        if not np.array_equal(r.docids, full):
            raise AssertionError(f"sharded serving at rung {level} differs "
                                 f"from the single-device engine")
    invariants.check_serve(loop).raise_if_failed()
    invariants.check_engine(e4).raise_if_failed()

    def adm():
        return AdmissionController(rollover_at=0.6, shed_at=0.6,
                                   min_segment_docs=10_000)
    h1, h4 = mk(adm(), False), mk(adm(), True)
    for docs in batches:
        if h1.ingest(docs) != h4.ingest(docs):
            raise AssertionError("engine sheds differ between the sharded "
                                 "and the single-device engine")
    if not h1.stats.shed_batches == h4.stats.shed_batches > 0:
        raise AssertionError("no batch was shed")
    loop = serve.ServeLoop(h4, serve.ServeConfig(ingest_reject_util=0.6))
    rej = loop.submit_ingest(batches[0])
    if not (isinstance(rej, serve.Rejected) and rej.reason ==
            "pool_pressure" and rej.retry_after_s > 0):
        raise AssertionError(f"expected a pool-pressure rejection with "
                             f"retry-after, got {rej!r}")
    h4.segments.rollover()
    h4._sync_frozen()
    loop.refresh_pressure()          # the engine changed outside step()
    if not isinstance(loop.submit_ingest(batches[0]), int):
        raise AssertionError("the retried batch was rejected after the "
                             "rollover")
    loop.step(force=True)
    if loop.stats.ingest_applied != 1:
        raise AssertionError("the retried batch was not applied")
    invariants.check_serve(loop).raise_if_failed()
    invariants.check_engine(h4).raise_if_failed()
    out = dict(emergency_rollovers=e4.stats.emergency_rollovers,
               engine_sheds=h4.stats.shed_batches,
               retry_after_s=rej.retry_after_s)
    log(f"sharded serving: {json.dumps(out)}; rungs 0 and 3 equal the "
        f"single-device engine; the rejected batch landed after a "
        f"rollover; check_serve and check_engine ok")
    return out


def phase_sharded_small(tmp: str) -> dict:
    """8(b): phase 4's stream at its 2**16-tweet segments over four
    shards: >= 3 rollovers under CompactionPolicy(fanout=2), every batch
    journaled and a snapshot mid-stream; every query kind batched and
    ``batched=False``, bit-equal and equal to the brute force; recovery
    on the card with an equal fingerprint; a two-shard mesh and a
    truncated archive refused; every ``FaultPlan`` kind on a four-shard
    mesh; the sharded serving case."""
    small = 1 << 16
    vocab = 1 << 16
    sdocs = make_stream(vocab, 4 * small + small // 2, seed=7)
    layout, _, fmax = shard_layout(sdocs, vocab, small)
    eng = sharded_engine(layout, vocab, small, fmax,
                         compaction=CompactionPolicy(fanout=2))
    snap = os.path.join(tmp, "sharded.snap")
    jrnl = os.path.join(tmp, "sharded.jrnl")
    starts = range(0, sdocs.shape[0], BATCH)
    snap_at = len(starts) // 2
    with recovery.IngestJournal(jrnl) as journal:
        for i, s in enumerate(starts):
            if i == snap_at:
                recovery.snapshot(eng, snap, seq=i)
            journal.append(sdocs[s: s + BATCH])
            eng.ingest(sdocs[s: s + BATCH])
    eng.check_health()
    fp = recovery.engine_fingerprint(eng)
    tiers = [fz.tier for fz in eng.segments.frozen]
    rolls = (eng.stats.rollovers, eng.stats.compactions)
    if rolls[0] < 3 or rolls[1] < 1:
        raise AssertionError(f"rollovers {rolls[0]}, compactions "
                             f"{rolls[1]}")
    queries, pairs = query_batch(sdocs, vocab, 16, seed=2)
    batched = run_queries(eng, queries, pairs, 16)
    eng.batched = False
    seq = run_queries(eng, queries, pairs, 16)
    bf = BruteForce(sdocs, {t for q in queries for t in q}, vocab)
    want = oracle_answers(bf, queries, pairs)
    for kind in batched:
        check_answers(f"sharded {kind} batched", batched[kind][0],
                      want[kind])
        check_answers(f"sharded {kind} sequential", seq[kind][0],
                      want[kind])
    invariants.check_engine(eng).raise_if_failed()
    del eng
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = recovery.recover(snap, jrnl, expect_seq=len(starts),
                           device="cuda")
    torch.cuda.synchronize()
    t_rec = time.perf_counter() - t0
    if recovery.engine_fingerprint(rec) != fp:
        raise AssertionError("the recovered sharded engine's fingerprint "
                             "differs from the uncrashed engine's")
    got = run_queries(rec, queries, pairs, 16)
    for kind in got:
        check_answers(f"sharded {kind} recovered", got[kind][0],
                      batched[kind][0])
    del rec
    try:
        recovery.restore(snap, mesh=make_doc_mesh(2, device="cuda"),
                         device="cuda")
    except ValueError as exc:
        if "shard" not in str(exc):
            raise
    else:
        raise AssertionError("a four-shard archive restored on two shards")
    with open(snap, "rb") as f:
        blob = f.read()
    cut = os.path.join(tmp, "sharded_cut.snap")
    with open(cut, "wb") as f:
        f.write(blob[: len(blob) * 2 // 5])
    try:
        recovery.restore(cut, device="cuda")
    except recovery.CorruptSnapshotError:
        pass
    else:
        raise AssertionError("a truncated sharded archive restored")
    log(f"sharded phase 4 depth: {len(starts)} batches over {SHARDS} "
        f"shards, {rolls[0]} rollovers, {rolls[1]} compactions, frozen "
        f"tiers {tiers}; {len(queries)} queries of "
        f"each kind batched == sequential == brute force; snapshot at "
        f"batch {snap_at} ({len(blob)} bytes), recovered on the card in "
        f"{t_rec:.2f} s with an equal fingerprint and equal answers; a "
        f"two-shard mesh raises ValueError, a truncated archive "
        f"CorruptSnapshotError")
    torch.cuda.empty_cache()
    kinds = {}
    for kind in faults.KINDS:
        res = faults.run_plan(faults.FaultPlan(kind=kind, seed=13), tmp,
                              mesh=make_doc_mesh(SHARDS, device="cuda"),
                              device="cuda")
        kinds[kind] = ("raised" if res.raised is not None else
                       f"recovered (crashed={res.crashed})")
    log(f"sharded fault plans on the card: {json.dumps(kinds)}")
    return dict(recover_s=t_rec, archive_bytes=len(blob), tiers=tiers,
                rollovers=rolls[0], compactions=rolls[1],
                fault_plans=kinds, serving=sharded_serving())


# ---------------------------------------------------------------------------
# phase 8c: the index on ranks, one shard per process (torch.distributed)
# ---------------------------------------------------------------------------
RANK_SHARDS = 4               # rank processes of (i) and (iii)
RANK_QUERIES = 8              # phase 3's first 8 queries of each kind
RANK_TIMEOUT = 600            # s: each rank world, and each collective
# the ranked serving stretch: one step a rung, None for the gauge; a
# bucket of one request of each kind before each step (max_batch 8, cut
# from 32: each dispatch takes the card's turn for its frozen side)
RANK_STRETCH = (None, serve.DEGRADE_NONE, serve.DEGRADE_FROZEN_ONLY)
RANK_BUCKET = 8


def answer_digest(a) -> str:
    """sha256 of one answer over int64 bytes (a scored answer's docids
    then scores)."""
    h = hashlib.sha256()
    for part in (a if isinstance(a, tuple) else (a,)):
        h.update(np.ascontiguousarray(part, np.int64).tobytes())
        h.update(b"|")
    return h.hexdigest()


def answer_digests(answers: dict) -> dict:
    """``{kind: [sha256 of each answer]}``: what the ranks send back to
    be held against the brute force and phase 8a."""
    return {kind: [answer_digest(a) for a in got]
            for kind, got in answers.items()}


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_world(cfg: dict, n: int, tmp: str,
                timeout: float = RANK_TIMEOUT) -> dict:
    """Start ``n`` processes of this script (``--rank-child``) in one
    world on ``cfg['backend']``, writing into ``tmp``; :func:`end_world`
    waits for them, at most ``timeout`` s (each collective too)."""
    port = _free_port()
    procs, logs = [], []
    # the host's cores split between the ranks
    env = dict(os.environ, OMP_NUM_THREADS=str(max(
        1, (os.cpu_count() or n) // n)))
    for r in range(n):
        c = dict(cfg, rank=r, world=n, port=port, out=tmp, timeout=timeout)
        logs.append((open(os.path.join(tmp, f"rank{r}.out"), "w+"),
                     open(os.path.join(tmp, f"rank{r}.err"), "w+")))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-child",
             json.dumps(c)], stdout=logs[-1][0], stderr=logs[-1][1],
            text=True, env=env))
    return dict(procs=procs, logs=logs, tmp=tmp, n=n,
                backend=cfg["backend"], t0=time.perf_counter(),
                timeout=timeout)


def kill_world(w: dict) -> None:
    """Kill whatever is left of a :func:`start_world` world."""
    for p in w["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()


def end_world(w: dict) -> list:
    """Each rank's result dict of a :func:`start_world` world, in rank
    order; its wall time in ``w['wall_s']``.  A rank that fails, or a
    world that outlives its timeout, raises here (every process is
    killed first)."""
    procs, n = w["procs"], w["n"]
    deadline = w["t0"] + w["timeout"]
    try:
        # a rank that fails ends the world at once: its peers would wait
        # in their next collective until the timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs) or \
                    time.perf_counter() > deadline:
                break
            time.sleep(0.2)
        # still running, none failed: late (a world that ended long
        # before this call is not)
        late = (any(p.poll() is None for p in procs)
                and not any(p.returncode for p in procs))
    finally:
        kill_world(w)
    w["wall_s"] = time.perf_counter() - w["t0"]
    if late:
        raise AssertionError(f"the world of {n} ranks outlived "
                             f"{w['timeout']} s")
    failed = []
    for r, (p, (out, err)) in enumerate(zip(procs, w["logs"])):
        out.seek(0)
        err.seek(0)
        for line in out.read().splitlines():
            log(f"  rank {r} ({w['backend']}): {line}")
        tail = err.read()[-4000:]
        out.close()
        err.close()
        if p.returncode != 0:
            failed.append(f"rank {r} exited {p.returncode}:\n{tail}")
    if failed:
        raise AssertionError(f"a world of {n} ranks over {w['backend']} "
                             f"failed:\n" + "\n".join(failed))
    res = []
    for r in range(n):
        with open(os.path.join(w["tmp"], f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res


def rank_child(cfg: dict) -> int:
    """One rank of phase 8c (joins the world, builds its
    :func:`make_rank_mesh` shard on its card and runs ``cfg['run']``) or
    of phase 6r (``run == "recsys"``: :func:`rank_recsys`); writes its
    result as JSON."""
    import faulthandler
    faulthandler.enable()
    t0 = time.perf_counter()
    rank, n = cfg["rank"], cfg["world"]
    dev = torch.device(cfg["device"].format(rank=rank))
    torch.cuda.set_device(dev)
    _cuda.lib()                       # the parent's build, loaded
    with process_world(cfg["backend"], rank=rank, world_size=n,
                       port=cfg["port"], timeout_s=cfg["timeout"]):
        if cfg["run"] == "recsys":
            res, shard = rank_recsys(cfg), rank
        else:
            mesh = make_rank_mesh(n, device=dev)
            fn = rank_full if cfg["run"] == "full" else rank_small
            res, shard = fn(cfg, mesh), mesh.shard
    res.update(rank=rank, shard=shard, device=str(dev),
               seconds=time.perf_counter() - t0)
    with open(os.path.join(cfg["out"], f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def rank_full(cfg: dict, mesh) -> dict:
    """(i)/(iii) on one rank: phase 3's stream (the parent's file)
    through ``ShardedLifecycleEngine`` on the rank mesh with the shard
    pools ``cfg`` gives, one rollover, 2**20 more tweets, then the
    first 8 queries of each kind in one batch each; the snapshot and the
    fingerprint taken on the ranks.  ``bulk_append`` must launch once a
    batch on this rank, the three query kernels at least once; the
    rank's own ``intersect_mask`` calls (its shard's conjunctions at
    full width) are kept and, after the counts are read, replayed
    bit-equal to the plain version."""
    dev = mesh.device
    vocab, seg_docs, extra = cfg["vocab"], cfg["seg_docs"], cfg["extra"]
    docs = np.load(cfg["docs"], mmap_mode="r")
    fmax = cfg["fmax"]
    eng = ShardedLifecycleEngine(
        pointers.production_layout(tuple(cfg["spp"])), vocab, seg_docs,
        mesh, max_slices=int(analytical.slices_needed(Z, fmax)) + 1,
        max_len=engine_max_len(fmax), device=dev)
    total = seg_docs + extra
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for s in range(0, total, BATCH):
        if s == seg_docs - BATCH:
            torch.cuda.synchronize(dev)
            t_first = time.perf_counter() - t0
        eng.ingest(docs[s: s + BATCH])
        if s == seg_docs - BATCH:
            torch.cuda.synchronize(dev)
            t_roll = time.perf_counter() - t0 - t_first
    torch.cuda.synchronize(dev)
    t_after = time.perf_counter() - t0 - t_first - t_roll
    eng.check_health()
    if eng.stats.rollovers != 1:
        raise AssertionError(f"expected one rollover, saw "
                             f"{eng.stats.rollovers}")
    n_batches = total // BATCH
    ingest = ops.launch_counts()
    if ingest["bulk_append"] != n_batches:
        raise AssertionError(f"bulk_append launched "
                             f"{ingest['bulk_append']} times on this rank "
                             f"for {n_batches} batches")
    ingest_peak = torch.cuda.max_memory_allocated(dev)
    queries = [tuple(q) for q in cfg["queries"]]
    pairs = [tuple(p) for p in cfg["pairs"]]
    free, total_mem = torch.cuda.mem_get_info(dev)
    with keeping_intersect_calls([]) as calls:
        res, used = rank_queries(eng, queries, pairs, cfg.get("turns"))
    used = max(used, total_mem - free)
    counts = ops.launch_counts()
    for k in ("intersect_mask", "segment_intersect_mask_batched",
              "scored_intersect_batched"):
        if counts[k] <= 0:
            raise AssertionError(f"the rank never launched {k}")
    if len(calls) != counts["intersect_mask"]:
        raise AssertionError(f"{len(calls)} intersect_mask calls kept, "
                             f"{counts['intersect_mask']} launches counted")
    peak = max([ingest_peak] + [r[2] for r in res.values()])
    log(f"shard {mesh.shard}: {n_batches} batches, {t_first:.3f} s to the "
        f"rollover batch, launches {json.dumps(counts)}, peak "
        f"{peak / 2**30:.2f} GiB, card used up to {used / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    recovery.snapshot(eng, cfg["snap"], seq=n_batches)
    t_snap = time.perf_counter() - t0
    fp = recovery.engine_fingerprint(eng)
    slots = (eng.memory_slots_used(),
             eng.segments.active.shard_slots_used().tolist())
    shapes = sorted({(c[0][2], c[1][2]) for c in calls})
    n_calls = len(calls)
    t0 = time.perf_counter()
    err = replay_intersect_calls(calls, f"shard {mesh.shard}")
    t_replay = time.perf_counter() - t0
    del calls
    t0 = time.perf_counter()
    stretch = ranked_stretch(cfg, eng, mesh)
    t_stretch = time.perf_counter() - t0
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    crash = ranked_crash(cfg, mesh)
    crash["seconds"] = time.perf_counter() - t0
    return dict(
        stretch=stretch, stretch_s=t_stretch, crash=crash,
        intersect_calls=n_calls, intersect_shapes=shapes,
        intersect_max_abs_err=err, replay_s=t_replay,
        ingest_docs_per_s=(seg_docs - BATCH) / t_first,
        recycled_docs_per_s=extra / t_after, rollover_s=t_roll,
        query_ms={k: v[1] for k, v in res.items()},
        query_wait_ms={k: v[3] for k, v in res.items()},
        peak_bytes=peak, card_used_bytes=used,
        snapshot_s=t_snap, launches=counts, batches=n_batches,
        digests=answer_digests({k: v[0] for k, v in res.items()}),
        fingerprint=fp if mesh.shard == 0 else None,
        memory_slots_used=slots[0], shard_slots=slots[1])


@contextlib.contextmanager
def card_turns(eng, turns):
    """With ``turns`` (a lock file: ranks sharing one card) the ranks
    take turns on the card's memory for the replicated frozen side: once
    the active fan-out (its collectives) has returned, a rank frees its
    cached blocks and waits for the lock (``take``), evaluates the frozen
    side and copies the answers out, then unlocks (``release``).  No
    collective runs while the lock is held, so no rank waits in one for a
    rank that waits for the lock.  At full width four frozen evaluations
    at once do not fit the card (8a's disjunctive batch peaks at 35.77
    GiB).  Yields ``{"wait": s waiting for the lock, "take", "release",
    "on"}``; without ``turns`` take and release do nothing."""
    import fcntl
    dev = eng.device
    lock = None if not turns else open(turns, "a")
    held = {"wait": 0.0, "on": False}

    def take():
        if lock is None:
            return
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        fcntl.flock(lock, fcntl.LOCK_EX)
        held["wait"] += time.perf_counter() - t0
        held["on"] = True

    def release():
        if held["on"]:
            fcntl.flock(lock, fcntl.LOCK_UN)
            held["on"] = False
            torch.cuda.empty_cache()

    def after(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            take()
            return out
        return wrapped
    held.update(take=take, release=release)
    names = ("_active_batch", "_active_topk_batch", "_active_scored_batch")
    if lock is not None:
        for name in names:
            setattr(eng, name, after(getattr(eng, name)))
    try:
        yield held
    finally:
        if lock is not None:
            release()
            lock.close()
            for name in names:
                del eng.__dict__[name]


def rank_queries(eng, queries, pairs, turns) -> dict:
    """Each kind's batch of :data:`RANK_QUERIES` on this rank, taking
    :func:`card_turns` with the other ranks of the card: ``({kind:
    (answers, [ms], peak bytes, ms waiting for the card)}, the card's
    most used bytes seen at the end of a batch)``."""
    dev = eng.device
    out, used = {}, 0
    with card_turns(eng, turns) as held:
        for kind, batch, call in query_calls(eng, queries, pairs):
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.synchronize(dev)
            held["wait"] = 0.0
            t0 = time.perf_counter()
            got = call(batch[:RANK_QUERIES])
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated(dev)
            free, total = torch.cuda.mem_get_info(dev)
            used = max(used, total - free)
            held["release"]()
            out[kind] = (got, [ms], peak, held["wait"] * 1e3)
    return out, used


class TimedMesh:
    """A rank mesh whose ``broadcast`` (the serving loop's plan) is timed
    on the host clock, in ms a call."""

    def __init__(self, mesh):
        self.mesh, self.ms = mesh, []

    def __getattr__(self, name):
        return getattr(self.mesh, name)

    def broadcast(self, obj=None):
        t0 = time.perf_counter()
        out = self.mesh.broadcast(obj)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def ranked_stretch(cfg: dict, eng, mesh) -> dict:
    """The ranked ``ServeLoop`` on this rank's full-width engine: shard
    0's rank leads (its ``time.monotonic`` clock, the queues, the
    stats), the others follow its plans.  :data:`RANK_STRETCH`'s steps,
    one arrival batch of the parent's ``more`` file each and a bucket of
    one request of each kind (phase 3's queries in turn) before each,
    the rung left to the gauge or pinned.  Every dispatch takes the
    card's turn for its frozen side (:func:`card_turns`) and copies its
    answers out before the next fan-out.  The leader returns, for each
    response, (kind, terms, k, rung, applied docs and doc base at
    dispatch, digest) for the parent to hold against the brute force;
    every rank its launches over the stretch, its wait for the card,
    the plan broadcast's ms a step and its ``check_serve``."""
    from repro_torch.core import qexec
    more = np.load(cfg["more"])
    queries = [tuple(q) for q in cfg["queries"]]
    pairs = [tuple(p) for p in cfg["pairs"]]
    config = serve.ServeConfig(max_batch=RANK_BUCKET)
    ops.reset_launch_counts()
    with card_turns(eng, cfg.get("turns")) as held:
        if cfg.get("turns"):
            real = eng.dispatch

            def dispatch(kind, qs, frozen_only=False, **kw):
                if frozen_only:           # no fan-out: the frozen side now
                    held["take"]()
                res = real(kind, qs, frozen_only=frozen_only, **kw).wait()
                torch.cuda.synchronize(eng.device)
                held["release"]()
                return qexec.Pending((), lambda: res)
            eng.dispatch = dispatch
        loop = serve.ServeLoop(eng, config)
        timed = loop._mesh = TimedMesh(loop._mesh)
        log_rows, steps, pools = [], [], []
        if mesh.leads:
            kinds, r = serve.QUERY_KINDS, 0
            for i, level in enumerate(RANK_STRETCH):
                loop.submit_ingest(more[i * BATCH: (i + 1) * BATCH])
                asked = {}
                for kind in kinds:
                    terms = (pairs if kind == "phrase" else queries)[
                        r % len(queries)]
                    asked[loop.submit_query(kind, terms, k=SERVE_K)] = (
                        kind, [int(t) for t in terms])
                    r += 1
                applied = eng.doc_base + eng.segments.active.next_docid
                base = eng.doc_base
                pools.append(loop.pressure_components()["pool"])
                loop.force_level = level
                torch.cuda.synchronize(eng.device)
                t0 = time.perf_counter()
                loop.step(force=True)
                torch.cuda.synchronize(eng.device)
                steps.append((time.perf_counter() - t0) * 1e3)
                for resp in loop.take_responses():
                    kind, terms = asked.pop(resp.qid)
                    a = (resp.docids if resp.scores is None
                         else (resp.docids, resp.scores))
                    log_rows.append(dict(
                        kind=kind, terms=terms, k=SERVE_K, level=resp.level,
                        applied=int(applied), base=int(base),
                        latency_ms=resp.latency_s * 1e3,
                        digest=answer_digest(a)))
                if asked:
                    raise AssertionError(f"step {i}: {len(asked)} requests "
                                         f"got no response")
            loop.stop()
        else:
            loop.follow()
        eng.__dict__.pop("dispatch", None)
        wait_ms = held["wait"] * 1e3
    counts = ops.launch_counts()
    rep = invariants.check_serve(loop)
    st = loop.stats
    return dict(
        responses=log_rows, step_ms=steps, pool=pools,
        launches=counts, card_wait_ms=wait_ms,
        broadcast_ms=timed.ms, check_serve=[rep.ok, rep.render()],
        served=st.queries_served, served_by_level=list(st.served_by_level),
        applied=st.ingest_applied, stats=dataclasses.asdict(st))


def ranked_crash(cfg: dict, mesh) -> dict:
    """At phase 4's depth (2**16-tweet segments, seed 13's stream, pools
    from each shard's substream) the ranked loop with a journal on the
    leader, ``validate=True``, every response held against the stream's
    brute force on the leader: a snapshot mid-stream, then a crash
    inside a rollover on every rank (the site armed from the same plan)
    with requests in flight and batches queued; ``recover(mesh=)`` on
    every rank and ``resume_with``; the stream goes on; the fingerprint
    equals an uncrashed ranked run's, ``check_serve`` holds on every
    rank.  Then every ``FaultPlan`` kind on the ranks with
    ``device="cuda"``."""
    dev, tmp = mesh.device, cfg["out"]
    small = vocab = 1 << 16
    sdocs = make_stream(vocab, 4 * small + small // 2, seed=13)
    layout, _, fmax = shard_layout(sdocs, vocab, small, mesh.num_shards)

    def engine():
        return ShardedLifecycleEngine(
            layout, vocab, small, mesh,
            max_slices=int(analytical.slices_needed(Z, fmax)) + 1,
            max_len=engine_max_len(fmax),
            compaction=CompactionPolicy(fanout=2), validate=True,
            device=dev)

    batches = [sdocs[s: s + BATCH] for s in range(0, sdocs.shape[0], BATCH)]
    wal, snap = os.path.join(tmp, "crash.jrnl"), os.path.join(tmp,
                                                              "crash.snap")
    loop = serve.ServeLoop(
        engine(), journal=recovery.IngestJournal(wal) if mesh.leads
        else None)
    loop.force_level = serve.DEGRADE_NONE
    per_seg = small // BATCH
    arm = 5 * per_seg // 2                  # mid third segment
    drv = None
    if mesh.leads:
        queries, pairs = query_batch(sdocs, vocab, 12, seed=14)
        bf = BruteForce(sdocs, {t for q in queries for t in q}, vocab)
        drv = ServeDriver(loop, bf, batches, queries, pairs)
        loop.snapshot_now(snap)
        for i in range(arm):
            drv.submit_ingest()
            if i % (per_seg // 2) == 0:
                drv.submit_queries(n=5)
            drv.step()
            if i == per_seg + per_seg // 4:
                loop.snapshot_now(snap)     # a mid-stream snapshot
        loop.stop()
    else:
        loop.follow()
    crashed = False
    try:
        with faults.crash_site("crash_mid_rollover"):
            if mesh.leads:
                while drv.feed:
                    drv.submit_ingest()
                    drv.submit_ingest()
                    drv.submit_queries(n=5)
                    drv.step(force=True)    # requests in flight
                loop.stop()
            else:
                loop.follow()
    except faults.InjectedCrash:
        crashed = True
    if not crashed:
        raise AssertionError("the injected crash never fired")
    at_crash = (loop.in_flight_queries, loop.pending_ingest)
    if not (at_crash[0] and at_crash[1]):
        raise AssertionError(f"the crash came with {at_crash} requests in "
                             f"flight and batches queued")
    acked = mesh.broadcast(loop.journal.next_seq if mesh.leads else None)
    if mesh.leads:
        loop.journal.close()
    torn = loop.engine
    loop.engine = None
    del torn
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    rec = recovery.recover(snap, wal, mesh=mesh, expect_seq=acked,
                           device=dev)
    torch.cuda.synchronize(dev)
    t_rec = time.perf_counter() - t0
    loop.resume_with(rec, journal=recovery.IngestJournal(wal)
                     if mesh.leads else None)
    if mesh.leads:
        drv.drain()
        loop.journal.close()
        loop.stop()
    else:
        loop.follow()
    _, records = recovery.read_journal(wal)
    if len(records) != len(batches):
        raise AssertionError("an acked batch is missing from the journal")
    oracle = engine()
    for b in batches:
        oracle.ingest(b)
    fa = recovery.engine_fingerprint(loop.engine)
    fb = recovery.engine_fingerprint(oracle)
    fa.pop("stats"), fb.pop("stats")     # scored requests bump the stats
    if fa != fb:
        raise AssertionError("the recovered, resumed ranked engine differs "
                             "from the uncrashed one")
    invariants.check_serve(loop).raise_if_failed()
    st = loop.stats
    out = dict(acked=acked, in_flight=at_crash[0], queued=at_crash[1],
               recover_s=t_rec, ingest_recovered=st.ingest_recovered,
               queries_aborted=st.queries_aborted,
               checked=drv.checked if drv else None)
    del loop, rec, oracle
    torch.cuda.empty_cache()
    kinds = {}
    for kind in faults.KINDS:
        wd = os.path.join(tmp, "plans", kind)
        if mesh.leads:
            os.makedirs(wd)
        mesh.combine(0)
        res = faults.run_plan(faults.FaultPlan(kind=kind, seed=3), wd,
                              mesh=mesh, device=dev)
        kinds[kind] = ("raised" if res.raised is not None else
                       f"recovered (crashed={res.crashed})")
    out["fault_plans"] = kinds
    return out


def rank_small(cfg: dict, mesh) -> dict:
    """(ii): phase 8b's stream at 2**16-tweet segments on this rank mesh
    (one NCCL rank on the card), ``validate=True`` and
    ``CompactionPolicy(fanout=2)``: >= 3 rollovers, 16 queries of each
    kind batched and ``batched=False``, each equal to the brute force."""
    small = vocab = 1 << 16
    sdocs = make_stream(vocab, 4 * small + small // 2, seed=7)
    layout, _, fmax = shard_layout(sdocs, vocab, small, mesh.num_shards)
    eng = ShardedLifecycleEngine(
        layout, vocab, small, mesh,
        max_slices=int(analytical.slices_needed(Z, fmax)) + 1,
        max_len=engine_max_len(fmax), compaction=CompactionPolicy(fanout=2),
        validate=True, device=mesh.device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for s in range(0, sdocs.shape[0], BATCH):
        eng.ingest(sdocs[s: s + BATCH])
    torch.cuda.synchronize(mesh.device)
    t_ingest = time.perf_counter() - t0
    eng.check_health()
    rolls = (eng.stats.rollovers, eng.stats.compactions)
    if rolls[0] < 3 or rolls[1] < 1:
        raise AssertionError(f"rollovers {rolls[0]}, compactions "
                             f"{rolls[1]}")
    queries, pairs = query_batch(sdocs, vocab, 16, seed=2)
    batched = run_queries(eng, queries, pairs, 16)
    eng.batched = False
    seq = run_queries(eng, queries, pairs, 16)
    bf = BruteForce(sdocs, {t for q in queries for t in q}, vocab)
    want = oracle_answers(bf, queries, pairs)
    for kind in batched:
        check_answers(f"rank {kind} batched", batched[kind][0], want[kind])
        check_answers(f"rank {kind} sequential", seq[kind][0], want[kind])
    invariants.check_engine(eng).raise_if_failed()
    counts = ops.launch_counts()
    n_batches = -(-sdocs.shape[0] // BATCH)
    if counts["bulk_append"] != n_batches * len(mesh.local_shards):
        raise AssertionError(f"bulk_append launched "
                             f"{counts['bulk_append']} times for "
                             f"{n_batches} batches")
    for k in ("intersect_mask", "segment_intersect_mask_batched",
              "segment_intersect_mask", "scored_intersect_batched"):
        if counts[k] <= 0:
            raise AssertionError(f"the rank never launched {k}")
    return dict(rollovers=rolls[0], compactions=rolls[1],
                ingest_s=t_ingest, launches=counts,
                query_ms={k: v[1] for k, v in batched.items()})


def ranks_full(base: dict, name: str, backend: str, device: str,
               want_d, beside=None) -> dict:
    """(i) or (iii): one world of :data:`RANK_SHARDS` ranks at full width
    (``beside()``, if given, runs here meanwhile); the ranks' snapshot
    restored here as the stacked engine with the ranks' fingerprint,
    then every rank's answer digests held against the brute force's
    (``want_d``) and that engine's on the same queries.  Returns the
    world's summary."""
    with tempfile.TemporaryDirectory() as tmp:
        snap = os.path.join(tmp, "ranks.snap")
        shared = "{rank}" not in device
        w = start_world(dict(
            base, backend=backend, device=device, snap=snap,
            turns=os.path.join(tmp, "card.lock") if shared else None),
            RANK_SHARDS, tmp)
        try:
            if beside is not None:
                beside()
        finally:
            ranks = end_world(w)
        t0 = time.perf_counter()
        back = recovery.restore(snap, device="cuda")
        fp = json.loads(json.dumps(recovery.engine_fingerprint(back)))
        t_restore = time.perf_counter() - t0
        archive = os.path.getsize(snap)
        res = run_queries(back, [tuple(q) for q in base["queries"]],
                          [tuple(p) for p in base["pairs"]], RANK_QUERIES)
        stacked_d = answer_digests({k: v[0] for k, v in res.items()})
        for r in ranks:
            for kind, got in r["digests"].items():
                for what, want in (("the brute force", want_d[kind]),
                                   ("the stacked engine", stacked_d[kind])):
                    bad = [i for i, (g, x) in enumerate(zip(got, want))
                           if g != x]
                    if bad or len(got) != len(want):
                        raise AssertionError(
                            f"rank {r['rank']} {kind}: queries {bad} "
                            f"differ from {what}")
        del back, res
        gc.collect()
        torch.cuda.empty_cache()
    if fp != ranks[0]["fingerprint"]:
        raise AssertionError("the ranks' snapshot restored as the stacked "
                             "engine has another fingerprint")
    for r in ranks:
        log(f"phase 8c ({name}) shard {r['shard']} on {r['device']}: "
            f"ingest {r['ingest_docs_per_s']:.0f} docs/s (the world's "
            f"docs over this rank's time), rollover {r['rollover_s']:.3f} "
            f"s, recycled {r['recycled_docs_per_s']:.0f} docs/s; query "
            f"batches of {RANK_QUERIES} (ms, of it waiting for the card's "
            f"turn): " + ", ".join(
                f"{k} {v[0]:.1f} ({r['query_wait_ms'][k]:.1f})"
                for k, v in r["query_ms"].items())
            + f"; launches {json.dumps(r['launches'])}; "
            f"max_memory_allocated {r['peak_bytes'] / 2**30:.2f} GiB; "
            f"card used up to {r['card_used_bytes'] / 2**30:.2f} GiB; "
            f"snapshot {r['snapshot_s']:.2f} s; its {r['intersect_calls']} "
            f"intersect_mask calls (a, b shapes "
            f"{sorted({tuple(map(tuple, x)) for x in r['intersect_shapes']})}"
            f") replayed twice, bit-equal to the plain version, in "
            f"{r['replay_s']:.2f} s")
    log(f"phase 8c ({name}): {RANK_SHARDS} ranks over {backend}, "
        f"{RANK_QUERIES} queries of each kind: the ranks' archive "
        f"({archive} bytes) restored as the stacked engine in "
        f"{t_restore:.1f} s with an equal fingerprint; every rank's answer "
        f"equal to the brute force and to that stacked engine's; world "
        f"{w['wall_s']:.1f} s")
    return dict(
        wall_s=w["wall_s"], restore_s=t_restore, archive_bytes=archive,
        ranks=[{k: r[k] for k in (
            "shard", "device", "ingest_docs_per_s", "rollover_s",
            "recycled_docs_per_s", "query_ms", "query_wait_ms", "launches",
            "peak_bytes", "card_used_bytes", "snapshot_s", "intersect_calls",
            "intersect_max_abs_err", "replay_s", "stretch", "stretch_s",
            "crash")}
            for r in ranks])


def check_stretch(name: str, world: dict, bf) -> dict:
    """The ranked stretch and crash of one world (:func:`ranks_full`'s
    summary): every response's digest equal to :func:`rung_answer` on
    the brute force over the stream and the stretch's batches; every
    rank's ``check_serve`` ok, ``bulk_append`` launched once a rank per
    applied batch and the three query kernels at least once a rank; the
    crash recovered and every fault plan run on every rank.  Logs the
    stretch's times; returns them."""
    ranks = world["ranks"]
    lead = ranks[0]["stretch"]
    cfg = serve.ServeConfig(max_batch=RANK_BUCKET)
    for i, r in enumerate(lead["responses"]):
        ids, scs = rung_answer(bf, r["kind"], r["terms"], r["k"], r["level"],
                               r["applied"], r["base"], cfg)
        if answer_digest(ids if scs is None else (ids, scs)) != r["digest"]:
            raise AssertionError(
                f"ranked stretch response {i} ({r['kind']} {r['terms']} at "
                f"rung {r['level']}) differs from the brute force")
    if len(lead["responses"]) != len(RANK_STRETCH) * len(serve.QUERY_KINDS):
        raise AssertionError(f"{len(lead['responses'])} responses")
    for rk in ranks:
        st, n = rk["stretch"], len(RANK_STRETCH)
        if not st["check_serve"][0]:
            raise AssertionError(f"shard {rk['shard']}: check_serve failed: "
                                 f"{st['check_serve'][1]}")
        if st["stats"] != lead["stats"]:
            raise AssertionError(f"shard {rk['shard']}'s stats are not the "
                                 f"leader's")
        if not st["applied"] == st["launches"]["bulk_append"] == n:
            raise AssertionError(
                f"shard {rk['shard']}: bulk_append launched "
                f"{st['launches']['bulk_append']} times for {st['applied']} "
                f"applied batches of {n}")
        for k in ("segment_intersect_mask_batched", "intersect_mask",
                  "scored_intersect_batched"):
            if st["launches"][k] <= 0:
                raise AssertionError(f"shard {rk['shard']} never launched "
                                     f"{k} in the stretch")
        if set(rk["crash"]["fault_plans"]) != set(faults.KINDS):
            raise AssertionError(f"shard {rk['shard']}: fault plans "
                                 f"{rk['crash']['fault_plans']}")
    steps = lead["step_ms"]
    lat = [r["latency_ms"] for r in lead["responses"]]
    crash = ranks[0]["crash"]
    out = dict(
        served=len(lat), served_per_s=len(lat) / (sum(steps) / 1e3),
        step_ms=steps, step_p50_ms=float(np.median(steps)),
        step_max_ms=max(steps), latency_p50_ms=float(np.percentile(lat, 50)),
        latency_p99_ms=float(np.percentile(lat, 99)),
        levels=[r["level"] for r in lead["responses"]], pool=lead["pool"],
        card_wait_ms=[rk["stretch"]["card_wait_ms"] for rk in ranks],
        broadcast_ms_per_step=[
            sum(rk["stretch"]["broadcast_ms"]) / len(steps) for rk in ranks],
        stretch_s=[rk["stretch_s"] for rk in ranks],
        recover_s=[rk["crash"]["recover_s"] for rk in ranks],
        crash_s=[rk["crash"]["seconds"] for rk in ranks],
        crash=crash, launches=[rk["stretch"]["launches"] for rk in ranks])
    log(f"phase 8c ({name}) ranked serving: {len(steps)} steps (rungs "
        f"{out['levels']}, pool gauge {lead['pool']}), {out['served']} "
        f"responses equal to the brute force at their rungs, "
        f"{out['served_per_s']:.2f} served/s; step ms p50 "
        f"{out['step_p50_ms']:.1f}, max {out['step_max_ms']:.1f} (each "
        + ", ".join(f"{x:.1f}" for x in steps) + f"); request latency "
        f"p50 {out['latency_p50_ms']:.1f} ms, p99 "
        f"{out['latency_p99_ms']:.1f} ms on the leader's clock; each "
        f"rank's wait for the card (ms) "
        + ", ".join(f"{x:.1f}" for x in out["card_wait_ms"])
        + "; plan broadcast host ms a step by rank "
        + ", ".join(f"{x:.2f}" for x in out["broadcast_ms_per_step"])
        + "; check_serve ok on every rank, launches asserted")
    log(f"phase 8c ({name}) ranked crash at phase 4's depth: "
        f"{crash['in_flight']} requests in flight, {crash['queued']} "
        f"batches queued, {crash['acked']} acked; recover(mesh=) "
        + ", ".join(f"{x:.2f}" for x in out["recover_s"])
        + f" s by rank; resumed: {crash['ingest_recovered']} batches "
        f"recovered, {crash['queries_aborted']} requests aborted, "
        f"{crash['checked']} responses equal to the brute force, "
        f"fingerprint equal to the uncrashed ranked run; fault plans on "
        f"the ranks {json.dumps(crash['fault_plans'])}; crash and plans "
        + ", ".join(f"{x:.1f}" for x in out["crash_s"]) + " s by rank")
    return out


def rank_oracle(docs, vocab: int, total: int, n: int = RANK_QUERIES):
    """The first ``n`` AOL-like queries (and their pairs) over the
    stream's first ``total`` docs, drawn as phase 3 draws its
    :data:`MAIN_QUERIES` (the log's query lengths depend on how many are
    drawn, so ``--ranks-only`` runs the full run's queries), with a
    brute force's answers: ``(queries, pairs, answers)``."""
    queries, pairs = query_batch(docs[:total], vocab, MAIN_QUERIES, seed=1)
    queries, pairs = queries[:n], pairs[:n]
    bf = BruteForce(docs[:total], {t for q in queries for t in q}, vocab)
    return queries, pairs, oracle_answers(bf, queries, pairs)


def phase_ranks(docs, vocab: int, seg_docs: int, extra: int,
                oracle, beside=None) -> dict:
    """8(c): (i) four gloo ranks on card 0, one shard each, at full width
    (phase 3's stream, pools sized from each shard's substream as 8a's):
    every answer's digest equal to the brute force's (``oracle``) and to
    the stacked four-shard engine's, that engine restored here from the
    ranks' snapshot with an equal fingerprint; per-rank launches
    asserted; (ii) one NCCL rank at phase 8b's depth, beside (i); (iii)
    four NCCL ranks, one a card, at (i)'s size where the machine has
    four cards.  The ranks read the stream from a file the parent
    writes; ``beside()``, if given, runs in the parent while (i) runs.
    Four processes time-slicing one card is a correctness run, not a
    deployment's throughput."""
    queries, pairs, want = oracle
    t0 = time.perf_counter()
    layout, _, fmax = shard_layout(docs, vocab, seg_docs)
    log(f"phase 8c: pools {layout.slices_per_pool} slices a shard "
        f"({layout.total_slots} slots), shard head-term freq {fmax}; sized "
        f"in {time.perf_counter() - t0:.1f} s")
    base = dict(run="full", vocab=vocab, seg_docs=seg_docs, extra=extra,
                spp=list(layout.slices_per_pool), fmax=fmax,
                queries=[list(q) for q in queries],
                pairs=[list(p) for p in pairs])
    want_d = answer_digests(want)
    more = make_stream(vocab, len(RANK_STRETCH) * BATCH, seed=17)
    stretch_bf = []

    def beside_all():
        if beside is not None:
            beside()
        stream = np.concatenate([docs[: seg_docs + extra], more])
        stretch_bf.append(BruteForce(
            stream, {t for q in list(queries) + list(pairs) for t in q},
            vocab))
    out = {}
    gc.collect()
    torch.cuda.empty_cache()
    worlds = [("gloo", "gloo", "cuda:0")]
    if torch.cuda.device_count() >= RANK_SHARDS:
        worlds.append(("nccl4", "nccl", "cuda:{rank}"))
    with contextlib.ExitStack() as stack:
        # (ii) is small: it runs beside (i) on the same card
        small_w = start_world(dict(run="small", backend="nccl",
                                   device="cuda:0"), 1,
                              stack.enter_context(
                                  tempfile.TemporaryDirectory()))
        stack.callback(kill_world, small_w)
        tmp = stack.enter_context(tempfile.TemporaryDirectory())
        base["docs"] = os.path.join(tmp, "docs.npy")
        np.save(base["docs"], docs[: seg_docs + extra])
        base["more"] = os.path.join(tmp, "more.npy")
        np.save(base["more"], more)
        for name, backend, device in worlds:
            out[name] = ranks_full(base, name, backend, device, want_d,
                                   beside_all if name == "gloo" else None)
            out[name]["serving"] = check_stretch(name, out[name],
                                                 stretch_bf[0])
        (small,) = end_world(small_w)
    out["nccl4_ran"] = "nccl4" in out
    if not out["nccl4_ran"]:
        log(f"phase 8c (iii): not run, {torch.cuda.device_count()} card(s) "
            f"(four NCCL ranks need one card each)")
    log(f"phase 8c (ii): one NCCL rank at phase 8b's depth, beside (i) on "
        f"the card: {small['rollovers']} rollovers, {small['compactions']} "
        f"compactions, validate=True; 16 queries of each kind batched and "
        f"batched=False equal to the brute force; launches "
        f"{json.dumps(small['launches'])}; {small['seconds']:.1f} s on the "
        f"rank's clock")
    out["nccl1"] = small
    out["launches"] = {k: sum(r["launches"][k] for r in out["gloo"]["ranks"])
                       for k in out["gloo"]["ranks"][0]["launches"]}
    return out


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
    if (arch, shape) == ("dcn-v2", "serve_bulk"):
        record_step("dcn-v2 serve_bulk", arch, shape, {}, med / 1e3, peak, 6)
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
        if arch == "dlrm-mlperf":
            RANK_REFS["dlrm"] = dlrm_reference(cfg, params, seed)
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


# ---------------------------------------------------------------------------
# phase 6r: the recsys steps on ranks, each table sharded by rows
# ---------------------------------------------------------------------------
RECSYS_RANKS = 4              # gloo ranks sharing card 0
RECSYS_RANK_TIMEOUT = 420     # s: the world, and each collective
RANK_DLRM_SEED = 61           # the DLRM batch phase 6 keeps for 6r
RANK_DLRM_CALLS = 6           # DLRM forwards a rank: 1 warm-up + 5 timed
RANK_DCN_B = 16_384           # DCN-v2 train_batch / 4 (a cut for memory:
                              # four ranks carry the batch's activations)
RANK_DCN_STEPS = 2
RANK_LOGIT_ERR = 1e-5         # DLRM logits, ranks vs phase 6: max |diff| /
                              # max(1e-3, max |logit|); the bags bit-equal
RANK_TRAIN_TOL = dict(rtol=1e-5, atol=1e-5)   # DCN-v2, ranks vs one card
RANK_REFS = {}                # phase 6's DLRM batch, bags and logits
# the functional collectives (torch.distributed._functional_collectives)
# that DTensor's redistributions and the staged family call
FUNCOL_CALLS = ("all_reduce", "all_reduce_coalesced", "all_gather_tensor",
                "all_gather_single", "all_gather_tensor_autograd",
                "all_gather_single_autograd", "reduce_scatter_tensor",
                "reduce_scatter_single", "reduce_scatter_tensor_autograd",
                "reduce_scatter_single_autograd", "all_to_all_single",
                "all_to_all_single_autograd", "broadcast", "permute_tensor")


@contextlib.contextmanager
def no_card_tensor_over_gloo():
    """The guard of phase 6r's steps: a functional collective handed a
    CUDA tensor (over gloo, as every group of the world is) raises with
    its name, where gloo would crash the process.  ``DTensor``'s own
    redistributions call these; the staged family
    (``dist/collectives.py``) hands them host tensors and passes."""
    from torch.distributed import _functional_collectives as funcol
    saved = {n: getattr(funcol, n) for n in FUNCOL_CALLS
             if hasattr(funcol, n)}

    def guarded(name, fn):
        def call(*args, **kwargs):
            for a in ttree.leaves((list(args), dict(kwargs))):
                if isinstance(a, torch.Tensor) and a.is_cuda:
                    raise RuntimeError(
                        f"a DTensor collective on the path: {name} of a "
                        f"CUDA tensor over gloo (it would crash the rank)")
            return fn(*args, **kwargs)
        return call
    for n, fn in saved.items():
        setattr(funcol, n, guarded(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(funcol, n, fn)


def guard_holds(mesh) -> str:
    """The guard's positive control on a rank: a ``DTensor`` partial sum
    of a CUDA tensor redistributed to a replica under
    :func:`no_card_tensor_over_gloo` must raise before anything crosses
    gloo (the message, for the log)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    t = DTensor.from_local(torch.ones(4, dtype=torch.float64,
                                      device="cuda"), mesh,
                           [Replicate(), Partial()], run_check=False)
    try:
        with no_card_tensor_over_gloo():
            t.redistribute(mesh, [Replicate(), Replicate()])
    except RuntimeError as e:
        if "a DTensor collective on the path" in str(e):
            return str(e)
        raise
    raise AssertionError("the guard let a DTensor collective of a CUDA "
                         "tensor through")


def windowed_bags(seed: int) -> float:
    """In phase 6r's parent: the windowed kernels on synthetic bags at S
    = 2 and 4 windows of a 100,000-row table, fp32 and bf16 at D 16 and
    128, sum and mean, ids clipped at both ends, empty bags, positions
    before offsets[0] and after offsets[B]: each window's bags bit-equal
    to the windowed in-order sum (and, on single-row bags, to the
    windowed plain version), the windows' sum within ``BAG_ERR`` of the
    whole kernel's bags (bit-equal on single-row bags); each window's
    backward block bit-equal to the windowed in-order sum
    (``tbwd.in_order_backward``), and the blocks, concatenated, bit-equal
    to the whole table's backward (itself bit-equal to the in-order
    sum).  Returns the max |sum of windows - whole|."""
    rng = np.random.default_rng(seed)
    R, err, cases = 100_000, 0.0, 0
    for D in (16, 128):
        for dt in (torch.float32, torch.bfloat16):
            table = torch.randn(R, D, device="cuda").to(dt)
            for lens in (np.r_[0, 40, rng.integers(0, 41, 3000)],
                         np.ones(5000, np.int64)):
                off = np.concatenate([[7], 7 + np.cumsum(lens)])
                ids = rng.integers(-100, R + 100, int(off[-1]) + 9)
                ids[:4] = (-100, R + 99, 0, R - 1)
                idx = torch.as_tensor(ids, dtype=torch.int32, device="cuda")
                off = torch.as_tensor(off, dtype=torch.int32, device="cuda")
                g = torch.randn(len(lens), D, device="cuda")
                single = bool((lens == 1).all())
                for mode in ("sum", "mean"):
                    whole = ops.embedding_bag(table, idx, off, mode)
                    whole_g = ops.embedding_bag_backward(g, idx, off, mode,
                                                         R, dt)
                    if not torch.equal(_bits(whole_g), _bits(
                            tbwd.in_order_backward(g, idx, off, mode, R,
                                                   dt))):
                        raise AssertionError(
                            f"D={D} {dt} {mode}: the whole backward differs "
                            f"from the in-order sum")
                    for S in (2, 4):
                        parts, blocks = [], []
                        for k in range(S):
                            lo, hi = k * R // S, (k + 1) * R // S
                            win = dict(row_lo=lo, row_hi=hi, num_rows=R)
                            got = keb.embedding_bag(table[lo:hi], idx, off,
                                                    mode, **win)
                            name = (f"window {k}/{S} D={D} {dt} "
                                    f"{len(lens)} bags {mode}")
                            if not torch.equal(got, tbag.in_order_bags(
                                    table[lo:hi], idx, off, mode, **win)):
                                raise AssertionError(f"{name}: differs from "
                                                     f"the in-order sum")
                            if single and not torch.equal(
                                    got, ref.embedding_bag_ref(
                                        table[lo:hi], idx, off, mode, **win)):
                                raise AssertionError(f"{name}: differs from "
                                                     f"the plain version")
                            parts.append(got)
                            blocks.append(keb.embedding_bag_backward(
                                g, idx, off, mode, R, dt, row_lo=lo,
                                row_hi=hi))
                            if not torch.equal(_bits(blocks[-1]), _bits(
                                    tbwd.in_order_backward(
                                        g, idx, off, mode, R, dt, row_lo=lo,
                                        row_hi=hi))):
                                raise AssertionError(
                                    f"{name}: the backward block differs "
                                    f"from the windowed in-order sum")
                        total = sum(parts[1:], parts[0])
                        d = float((total - whole).abs().max())
                        scale = float(whole.abs().max())
                        if (single and not torch.equal(total, whole)) or \
                                d > BAG_ERR * max(scale, 1e-30):
                            raise AssertionError(
                                f"S={S} D={D} {dt} {mode}: windows sum to "
                                f"{d} from the whole bags")
                        if not torch.equal(_bits(torch.cat(blocks)),
                                           _bits(whole_g)):
                            raise AssertionError(
                                f"S={S} D={D} {dt} {mode}: the backward "
                                f"windows differ from the whole backward")
                        err = max(err, d)
                        cases += 1
    torch.cuda.synchronize()
    log(f"phase 6r windowed kernels: {cases} cases (S 2 and 4; D 16 and "
        f"128; fp32 and bf16; sum and mean; bags of 0-40 rows and of one; "
        f"clipped ids, empty bags, positions outside every bag): every "
        f"window bit-equal to the windowed in-order sum, single-row windows "
        f"to the windowed plain version; windows sum to the whole bags "
        f"within {err:.3g} (single-row bags bit-equal); backward windows "
        f"concatenated bit-equal to the whole backward, each block and the "
        f"whole backward bit-equal to the in-order sum")
    return err


def dlrm_reference(cfg, params, seed: int) -> dict:
    """Phase 6's single-card DLRM-MLPerf forward (bf16 table) of one
    seeded serve_p99 batch, kept on the host for phase 6r: the batch,
    the lookup's bags and the logits."""
    spec = registry.get_shape("dlrm-mlperf", "serve_p99")
    batch = recsys_batch(cfg, spec, np.random.default_rng([seed,
                                                           RANK_DLRM_SEED]))
    bags = []

    def keep(table, idx, off, mode="sum"):
        bags.append(real(table, idx, off, mode))
        return bags[-1]
    with bags_through(keep) as real:
        logits = rsteps.make_recsys_forward(cfg)(params, batch)
    return dict(batch={k: v.cpu() for k, v in batch.items()},
                bags=bags[0].cpu(), logits=logits.float().cpu())


def dcn_reference(seed: int) -> tuple:
    """Phase 6r's single-card DCN-v2 run (fp32, the whole table): the
    seed's parameters, ``RANK_DCN_STEPS`` AdamW steps at B
    ``RANK_DCN_B``; returns (params, AdamW state, losses, the last
    step's bag and backward calls, their profiler times), on the card."""
    cfg, entry = registry.get("dcn-v2").config, registry.get("dcn-v2")
    params = rsteps.init_params_for(entry, cfg, seed=seed, device="cuda")
    opt = toptim.AdamW()
    state = opt.init(params)
    step = rsteps.make_recsys_train_step(cfg, opt)
    losses = []
    with spying_bag_kernels() as calls:
        for b in dcn_batches(cfg, RANK_DCN_B, RANK_DCN_STEPS, seed):
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
    times = {}
    a, k = calls["forward"][-1]
    times["forward_ms"] = profiled_ms(lambda: keb.embedding_bag(*a, **k),
                                      "embedding_bag")[0]
    a, k = calls["backward"][-1]
    times["backward_ms"] = device_profile(
        lambda: keb.embedding_bag_backward(*a, **k), warm=True)["busy_ms"]
    del calls
    return params, state, losses, times


def rank_recsys(cfg: dict) -> dict:
    """One rank of phase 6r on card 0: the (1, 4) ``("data", "model")``
    mesh of the world, then (a) DLRM-MLPerf's bf16 table and (b) DCN-v2's
    two train steps, each with this rank's block of rows (made from the
    seed's stream) and the parent's batches; see :func:`phase_recsys_ranks`."""
    from repro_torch.dist import collectives as tcoll
    from repro_torch.launch import mesh as tmesh
    mesh = tmesh.make_mesh((1, RECSYS_RANKS), ("data", "model"), "cuda")
    res = {"guard": guard_holds(mesh)}
    psums = []
    real_psum = tcoll.mesh_psum

    def timed_psum(x, logical, rules=None):
        if logical != "rows":
            return real_psum(x, logical, rules)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = real_psum(x, logical, rules)
        torch.cuda.synchronize()
        psums.append((x.numel() * x.element_size(),
                      (time.perf_counter() - t0) * 1e3))
        return y
    tcoll.mesh_psum = timed_psum
    try:
        res["dlrm"] = rank_dlrm(cfg, mesh, psums)
        gc.collect()
        torch.cuda.empty_cache()
        res["dcn"] = rank_dcn(cfg, mesh, psums)
    finally:
        tcoll.mesh_psum = real_psum
    return res


def _rank_layout(mesh, arch: str, cfg, shape: str):
    """(rules, placement tree, this rank's table rows) of ``cfg`` at
    ``shape`` on ``mesh`` by the dry-run's ``rules_for``."""
    from repro_torch.dist.sharding import local_block, tree_shardings
    from repro_torch.launch import dryrun as tdry
    entry = registry.get(arch)
    rules = tdry.rules_for(mesh, entry, registry.get_shape(arch, shape), {})
    pl = tree_shardings(rules, rsteps.param_specs_for(entry, cfg))
    rows = local_block(rmodels.padded_rows(cfg.total_rows), mesh,
                       pl["table"])
    return rules, pl, rows


def _from_locals(values, mesh, placements):
    """Each rank's own blocks as ``DTensor``s (no collective: every rank
    made its blocks from the same seed)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.dist.sharding import distribute_tree
    return distribute_tree(values, mesh, placements, distribute=lambda t, m, p:
                           DTensor.from_local(t, m, p, run_check=False))


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


class _KernelSpy:
    """A stand-in for ``kernels.embedding_bag`` in ``ops``: its two bag
    wrappers keep each call's inputs, then run the module's (the
    wrappers, their launch counts and every other name stay the
    module's own)."""

    def __init__(self, mod, calls):
        self._mod, self._calls = mod, calls

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def embedding_bag(self, *a, **k):
        self._calls["forward"].append((a, k))
        return self._mod.embedding_bag(*a, **k)

    def embedding_bag_backward(self, *a, **k):
        self._calls["backward"].append((a, k))
        return self._mod.embedding_bag_backward(*a, **k)


@contextlib.contextmanager
def spying_bag_kernels():
    """``{"forward": [...], "backward": [...]}``: the inputs of every bag
    kernel call ``ops`` makes for the duration."""
    calls = {"forward": [], "backward": []}
    real = ops._eb
    ops._eb = _KernelSpy(real, calls)
    try:
        yield calls
    finally:
        ops._eb = real


def replay_windows(calls) -> tuple:
    """After the counts are read: each kept windowed forward call again,
    bit-equal to the windowed in-order sum and (single-row bags) to the
    windowed plain version; each backward call twice, bit-equal run to
    run, rows of one contribution bit-equal to the windowed plain
    version, the rest within ``BWD_ERR`` of the summed magnitudes.
    Returns (calls replayed, the backward's max |difference| from the
    plain version)."""
    n, err = 0, 0.0
    for a, k in calls["forward"]:
        table, idx, off, mode = a
        got = keb.embedding_bag(*a, **k)
        if not torch.equal(got, tbag.in_order_bags(table, idx, off, mode,
                                                   **k)):
            raise AssertionError("a windowed bag differs from the windowed "
                                 "in-order sum")
        lo, hi = tbag.bag_bounds(off, idx.numel())
        one = (hi - lo) == 1
        want = ref.embedding_bag_ref(table, idx, off, mode, **k)
        if not torch.equal(got[one], want[one]):
            raise AssertionError("a windowed single-row bag differs from "
                                 "the windowed plain version")
        n += 1
    for a, k in calls["backward"]:
        g, idx, off, mode, R, dtype = a
        got = keb.embedding_bag_backward(*a, **k)
        again = keb.embedding_bag_backward(*a, **k)
        if not torch.equal(_bits(got), _bits(again)):
            raise AssertionError("two windowed backward calls differ")
        want = ref.embedding_bag_backward_ref(*a, **k)
        lo_w, hi_w = k["row_lo"], k["row_hi"]
        pos = torch.arange(idx.numel(), device=idx.device)
        rows = idx.long().clamp(0, R - 1)
        inside = (pos >= off[0]) & (pos < off[-1]) & (rows >= lo_w) & \
            (rows < hi_w)
        cnt = torch.bincount(rows[inside] - lo_w, minlength=hi_w - lo_w)
        one, many = cnt == 1, cnt > 1
        if not torch.equal(_bits(got[one]), _bits(want[one])) or \
                bool((got[cnt == 0] != 0).any()):
            raise AssertionError("a windowed backward row of one "
                                 "contribution differs from the plain "
                                 "version")
        mag = ref.embedding_bag_backward_ref(g.abs(), idx, off, mode, R,
                                             torch.float32, **k)[many]
        d = (got[many].float() - want[many].float()).abs()
        if bool((d > BWD_ERR * mag).any()):
            raise AssertionError("a windowed backward row beyond "
                                 f"{BWD_ERR} of its summed magnitudes")
        err = max(err, float(d.max()) if d.numel() else 0.0)
        n += 1
    return n, err


def _turns(fn):
    """``fn()`` on each rank in turn, the others waiting (a barrier after
    each turn): the card's time belongs to one rank while it measures."""
    import torch.distributed as dist
    out = None
    for r in range(dist.get_world_size()):
        if dist.get_rank() == r:
            out = fn()
        dist.barrier()
    return out


def rank_dlrm(cfg: dict, mesh, psums: list) -> dict:
    """(a) on one rank: DLRM-MLPerf's bf16 table, rows over ``("data",
    "model")`` (``rules_for``'s layout past 5e7 rows), this rank's
    46,941,952 rows made from the seed's stream; the parent's serve_p99
    batch through ``make_recsys_forward`` ``RANK_DLRM_CALLS`` times
    (launches asserted), the bags and logits written for the parent; the
    kept windowed call replayed, and timed in this rank's turn."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.dist.sharding import Resharding, use_rules
    arch = "dlrm-mlperf"
    entry = registry.get(arch)
    c = dataclasses.replace(entry.config, param_dtype="bfloat16")
    rules, pl, (lo, hi) = _rank_layout(mesh, arch, c, "serve_p99")
    t0 = time.perf_counter()
    params = rsteps.init_params_for(entry, c, seed=cfg["seed"],
                                    device="cuda", table_rows=(lo, hi))
    params = _from_locals(params, mesh, pl)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    host = torch.load(os.path.join(cfg["out"], "dlrm_batch.pt"))
    batch = _from_locals({k: v.cuda() for k, v in host.items()}, mesh,
                         {k: rules.placements(("batch",) + (None,) * (
                             v.dim() - 1)) for k, v in host.items()})
    fwd = rsteps.make_recsys_forward(c)
    bags = []

    def keep(table, idx, off, mode="sum"):
        bags.append(real(table, idx, off, mode))
        return bags[-1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    del psums[:]
    times = []
    with no_card_tensor_over_gloo(), use_rules(rules), \
            implicit_replication(), Resharding(), \
            spying_bag_kernels() as calls, bags_through(keep) as real:
        for _ in range(RANK_DLRM_CALLS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits = fwd(params, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    counts = ops.launch_counts()
    want = RANK_DLRM_CALLS * LOOKUPS["dot"]
    if counts["embedding_bag"] != want or sum(counts.values()) != want:
        raise AssertionError(f"DLRM on a rank: launches {counts}, expected "
                             f"{want} embedding_bag")
    peak = torch.cuda.max_memory_allocated()
    reduce = list(psums)
    calls["forward"] = calls["forward"][-1:]
    replayed, _ = replay_windows(calls)
    bag = _local(bags[-1]).float()
    out = _local(logits).float()
    if not torch.isfinite(out).all():
        raise AssertionError("DLRM on a rank: logits not finite")
    rank = mesh.get_rank()
    if rank == 0:
        torch.save({"bags": bag.cpu(), "logits": out.cpu()},
                   os.path.join(cfg["out"], "dlrm_out.pt"))
    a, k = calls["forward"][0]
    table, idx, off, mode = a
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def timing():
        row = dict(
            device_ms=profiled_ms(lambda: keb.embedding_bag(*a, **k),
                                  "embedding_bag")[0],
            ms=cuda_ms_cold(lambda: keb.embedding_bag(*a, **k), flush),
            plain_ms=cuda_ms_cold(lambda: ref.embedding_bag_ref(*a, **k),
                                  flush))
        clipped = idx.long().clamp(0, k["num_rows"] - 1)
        mine = clipped[(clipped >= lo) & (clipped < hi)]
        need = (torch.unique(mine).numel() * table.shape[1] *
                table.element_size() + idx.numel() * 4 + off.numel() * 4 +
                (off.numel() - 1) * table.shape[1] * 4)
        row.update(bytes=need, bound_ms=need / HBM_BYTES_PER_S * 1e3,
                   rows_in_window=int(mine.numel()))
        return row
    timed = _turns(timing)
    med = float(np.median(times[1:]))
    dev_ms = ("not measured" if timed["device_ms"] is None
              else f"{timed['device_ms']:.4f}")
    log(f"6r (a) dlrm-mlperf rank {rank}: rows [{lo}, {hi}) of "
        f"{k['num_rows']} ({(hi - lo) * table.shape[1] * 2 / 2**30:.2f} GiB "
        f"bf16) made in {init_s:.1f} s; forward {med:.3f} ms median of "
        f"{len(times) - 1} ({', '.join(f'{t:.2f}' for t in times[1:])}); "
        f"bag reduce {reduce[-1][0]} bytes, "
        f"{np.median([r[1] for r in reduce]):.3f} ms host median over "
        f"{len(reduce)}; launches {counts['embedding_bag']} = "
        f"{RANK_DLRM_CALLS} x {LOOKUPS['dot']}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; its windowed call "
        f"({timed['rows_in_window']} of {idx.numel()} rows in the window) "
        f"{dev_ms} ms by the profiler, {timed['ms']:.4f} flushed, plain "
        f"{timed['plain_ms']:.4f}, bound {timed['bound_ms']:.4f}; "
        f"{replayed} windowed call replayed bit-equal")
    return dict(rows=[lo, hi], init_s=init_s, forward_ms=times,
                reduce=reduce, launches=counts, peak_bytes=peak,
                timing=timed, replayed=replayed,
                bags_sha=hashlib.sha256(bag.cpu().numpy().tobytes()
                                        ).hexdigest())


def rank_dcn(cfg: dict, mesh, psums: list) -> dict:
    """(b) on one rank: DCN-v2 as published (fp32), rows over ``model``
    (``rules_for``'s layout), this rank's 8,440,704 rows made from the
    seed's stream; ``RANK_DCN_STEPS`` AdamW steps at B ``RANK_DCN_B`` on
    the parent's batches (made here from the same seed), launches
    asserted (one forward bag and one backward a step); this rank's
    blocks of the table and its moments, and (rank 0) every replicated
    leaf, written for the parent; the last step's windowed calls
    replayed, and timed in this rank's turn."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.dist.sharding import Resharding, use_rules
    entry = registry.get("dcn-v2")
    c = entry.config
    rules, pl, (lo, hi) = _rank_layout(mesh, "dcn-v2", c, "train_batch")
    t0 = time.perf_counter()
    params = _from_locals(rsteps.init_params_for(
        entry, c, seed=cfg["seed"], device="cuda", table_rows=(lo, hi)),
        mesh, pl)
    opt = toptim.AdamW()
    state = opt.init(params)
    step = rsteps.make_recsys_train_step(c, opt)
    batches = [_from_locals(b, mesh, {k: rules.placements(
        ("batch",) + (None,) * (v.dim() - 1)) for k, v in b.items()})
        for b in dcn_batches(c, RANK_DCN_B, RANK_DCN_STEPS, cfg["seed"])]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    del psums[:]
    times, losses = [], []
    with no_card_tensor_over_gloo(), use_rules(rules), \
            implicit_replication(), Resharding(), \
            spying_bag_kernels() as calls:
        for b in batches:
            del calls["forward"][:], calls["backward"][:]
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, state, m = step(params, state, b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(float(_local(m["loss"])))
    counts = ops.launch_counts()
    want = {"embedding_bag": RANK_DCN_STEPS * LOOKUPS["cross"],
            "embedding_bag_backward": RANK_DCN_STEPS}
    if {k: v for k, v in counts.items() if v} != want:
        raise AssertionError(f"DCN-v2 on a rank: launches {counts}, "
                             f"expected {want}")
    peak = torch.cuda.max_memory_allocated()
    reduce = list(psums)
    replayed, bwd_err = replay_windows(calls)
    rank = mesh.get_rank()
    blocks = {k: _local(t).cpu() for k, t in (
        ("table", params["table"]), ("mu", state.mu["table"]),
        ("nu", state.nu["table"]))}
    if rank == 0:
        def rest(tr):
            return {k: ttree.tree_map(lambda t: _local(t).cpu(), v)
                    for k, v in tr.items() if k != "table"}
        blocks.update(params_rest=rest(params), mu_rest=rest(state.mu),
                      nu_rest=rest(state.nu))
    torch.save(dict(blocks, rows=(lo, hi), losses=losses),
               os.path.join(cfg["out"], f"dcn_rank{rank}.pt"))
    del blocks
    (fa, fk), (ba, bk) = calls["forward"][-1], calls["backward"][-1]
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    g, idx = ba[0], ba[1]
    need = ((hi - lo) * g.shape[1] * 4 + g.numel() * 4 + idx.numel() * 4
            + ba[2].numel() * 4)

    def timing():
        return dict(
            backward_bytes=need,
            backward_bound_ms=need / HBM_BYTES_PER_S * 1e3,
            forward_device_ms=profiled_ms(
                lambda: keb.embedding_bag(*fa, **fk), "embedding_bag")[0],
            forward_ms=cuda_ms_cold(lambda: keb.embedding_bag(*fa, **fk),
                                    flush),
            backward_device_ms=device_profile(
                lambda: keb.embedding_bag_backward(*ba, **bk),
                warm=True)["busy_ms"],
            backward_ms=cuda_ms_cold(
                lambda: keb.embedding_bag_backward(*ba, **bk), flush),
            backward_plain_ms=cuda_ms_cold(
                lambda: ref.embedding_bag_backward_ref(*ba, **bk), flush))
    timed = _turns(timing)
    fdev = ("not measured" if timed["forward_device_ms"] is None
            else f"{timed['forward_device_ms']:.4f}")
    log(f"6r (b) dcn-v2 rank {rank}: rows [{lo}, {hi}), made in "
        f"{init_s:.1f} s; steps {', '.join(f'{t:.1f}' for t in times)} ms "
        f"(B {RANK_DCN_B}), losses {losses}; bag reduce "
        f"{reduce[0][0]} bytes, "
        f"{', '.join(f'{r[1]:.3f}' for r in reduce)} ms host; launches "
        f"{json.dumps(want)}; max_memory_allocated {peak / 2**30:.2f} GiB; "
        f"windowed forward {fdev} ms by the profiler, "
        f"{timed['forward_ms']:.4f} flushed; windowed backward "
        f"{timed['backward_device_ms']:.4f} ms device by the profiler, "
        f"{timed['backward_ms']:.4f} flushed, plain "
        f"{timed['backward_plain_ms']:.4f}, bound "
        f"{timed['backward_bound_ms']:.4f}; {replayed} windowed calls "
        f"replayed (forward bit-equal, backward rows of one contribution "
        f"bit-equal)")
    return dict(rows=[lo, hi], init_s=init_s, step_ms=times, losses=losses,
                reduce=reduce, launches=counts, peak_bytes=peak,
                timing=timed, replayed=replayed, backward_err=bwd_err)


def dlrm_alone(seed: int) -> dict:
    """``--recsys-ranks-only``: phase 6's DLRM-MLPerf reference alone (the
    bf16 table on the card for one forward, then freed)."""
    arch = "dlrm-mlperf"
    cfg = dataclasses.replace(registry.get(arch).config,
                              param_dtype="bfloat16")
    params = rsteps.init_params_for(registry.get(arch), cfg, seed=seed,
                                    device="cuda")
    out = dlrm_reference(cfg, params, seed)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _close(name, got, want, tol, scale=False) -> float:
    """``got`` (host) within ``tol`` of ``want`` (atol times the largest
    |want| with ``scale``: Adam's moments); the max |difference|."""
    want = want.float().cpu()
    got = got.float()
    atol = tol["atol"] * (float(want.abs().max()) if scale else 1.0)
    d = (got - want).abs()
    if got.shape != want.shape or bool((d > atol + tol["rtol"] *
                                        want.abs()).any()):
        raise AssertionError(f"{name}: beyond {tol} of the single card "
                             f"(max |diff| {float(d.max())})")
    return float(d.max()) if d.numel() else 0.0


def phase_recsys_ranks(seed: int) -> dict:
    """Phase 6r: the recsys steps on ranks, on one card.  In this process:
    the windowed kernels on synthetic bags (:func:`windowed_bags`) and
    DCN-v2's single-card reference steps (:func:`dcn_reference`), kept on
    the card.  Then one world of ``RECSYS_RANKS`` gloo ranks on card 0
    (``--rank-child`` processes, killed after ``RECSYS_RANK_TIMEOUT`` s),
    each on the (1, 4) ``("data", "model")`` mesh with its own block of
    rows: (a) DLRM-MLPerf's bf16 table over all four ranks, phase 6's
    batch: the bags bit-equal to phase 6's and the logits within
    ``RANK_LOGIT_ERR``; (b) DCN-v2's two train steps: losses, the
    gathered table and its moments, and every replicated leaf within
    ``RANK_TRAIN_TOL`` of the single card.  No ``DTensor`` collective
    runs on a CUDA tensor (:func:`no_card_tensor_over_gloo`)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    win_err = windowed_bags(seed)
    dl = RANK_REFS.get("dlrm") or dlrm_alone(seed)
    t0 = time.perf_counter()
    ref_p, ref_s, ref_losses, ref_times = dcn_reference(seed)
    gc.collect()
    torch.cuda.empty_cache()
    fwd_ms = ("not measured" if ref_times["forward_ms"] is None
              else f"{ref_times['forward_ms']:.4f}")
    log(f"6r (b) single card: dcn-v2 {RANK_DCN_STEPS} steps at B "
        f"{RANK_DCN_B} in {time.perf_counter() - t0:.1f} s, losses "
        f"{ref_losses}; its last step's unsharded bag {fwd_ms} ms and "
        f"backward {ref_times['backward_ms']:.4f} ms device by the "
        f"profiler")
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(dl["batch"], os.path.join(tmp, "dlrm_batch.pt"))
        w = start_world(dict(run="recsys", backend="gloo", device="cuda:0",
                             seed=seed), RECSYS_RANKS, tmp,
                        timeout=RECSYS_RANK_TIMEOUT)
        ranks = end_world(w)
        got = torch.load(os.path.join(tmp, "dlrm_out.pt"))
        if not torch.equal(got["bags"], dl["bags"]) or \
                len({r["dlrm"]["bags_sha"] for r in ranks}) != 1:
            raise AssertionError("6r (a): the ranks' bags differ from phase "
                                 "6's single-card bags")
        scale = max(float(dl["logits"].abs().max()), 1e-3)
        logit_err = float((got["logits"] - dl["logits"]).abs().max())
        if got["logits"].shape != dl["logits"].shape or \
                logit_err > RANK_LOGIT_ERR * scale:
            raise AssertionError(f"6r (a): logits {logit_err} from phase "
                                 f"6's (limit {RANK_LOGIT_ERR} x {scale})")
        errs = {"table": 0.0, "mu": 0.0, "nu": 0.0, "rest": 0.0}
        for r in range(RECSYS_RANKS):
            part = torch.load(os.path.join(tmp, f"dcn_rank{r}.pt"))
            lo, hi = part["rows"]
            _close(f"6r (b) rank {r} losses", torch.tensor(part["losses"]),
                   torch.tensor(ref_losses), RANK_TRAIN_TOL)
            for k, want in (("table", ref_p["table"]),
                            ("mu", ref_s.mu["table"]),
                            ("nu", ref_s.nu["table"])):
                errs[k] = max(errs[k], _close(
                    f"6r (b) rank {r} {k} rows [{lo}, {hi})", part[k],
                    want[lo:hi], RANK_TRAIN_TOL, scale=k != "table"))
            if r == 0:
                for k, tr, sc in (("params_rest", ref_p, False),
                                  ("mu_rest", ref_s.mu, True),
                                  ("nu_rest", ref_s.nu, True)):
                    want = {n: v for n, v in tr.items() if n != "table"}
                    for g_, w_ in zip(ttree.leaves(part[k]),
                                      ttree.leaves(want)):
                        errs["rest"] = max(errs["rest"], _close(
                            f"6r (b) {k}", g_, w_, RANK_TRAIN_TOL, sc))
            del part
    del ref_p, ref_s
    gc.collect()
    torch.cuda.empty_cache()
    launches = {"embedding_bag": sum(r["dlrm"]["launches"]["embedding_bag"]
                                     + r["dcn"]["launches"]["embedding_bag"]
                                     for r in ranks),
                "embedding_bag_backward": sum(
                    r["dcn"]["launches"]["embedding_bag_backward"]
                    for r in ranks)}
    log(f"6r: {RECSYS_RANKS} gloo ranks on card 0, world {w['wall_s']:.1f} "
        f"s: (a) dlrm-mlperf bags bit-equal to phase 6's, logits within "
        f"{logit_err:.3g} (limit {RANK_LOGIT_ERR} x {scale:.3g}); (b) "
        f"dcn-v2 losses, table rows, moments and replicated leaves within "
        f"{RANK_TRAIN_TOL} of the single card (max |diff| table "
        f"{errs['table']:.3g}, mu {errs['mu']:.3g}, nu {errs['nu']:.3g}, "
        f"the rest {errs['rest']:.3g}); launches {json.dumps(launches)}; no "
        f"DTensor collective on a CUDA tensor (the guard's control on each "
        f"rank: {ranks[0]['guard']!r})")
    return dict(wall_s=w["wall_s"], windowed_err=win_err,
                logit_err=logit_err, train_err=errs, launches=launches,
                single=ref_times, single_losses=ref_losses,
                ranks=[{k: r[k] for k in ("rank", "dlrm", "dcn", "seconds")}
                       for r in ranks])


def ranked_rows(table: list, ranked: dict) -> None:
    """Join phase 6r's launches to the table's rows of the two bag
    kernels that are there and not joined yet (``path`` gains
    ``recsys_ranks``)."""
    for row in table:
        name = row["name"]
        if name in ranked["launches"] and "recsys_ranks" not in row["path"]:
            row["launches"] += ranked["launches"][name]
            row["path"] += "+recsys_ranks"


# ---------------------------------------------------------------------------
# phase 9: the LMs at full width (forward, loss, prefill, decode)
# ---------------------------------------------------------------------------
# q_chunk per cell: the reference's overrides (src/repro/configs/
# registry.py:150-159; prefill_32k 256 for Gemma3 and Qwen2-MoE, 128 for
# Grok-1; train_4k 512)
PREFILL_LEN = 32768           # prefill_32k's length, at B = 1 (a cut)
TRAIN_LEN = 4096              # train_4k's length, at B = 1
GROK_LEN = 8192               # Grok-1's prefill and forward, B = 1
MOE_DECODE_LEN = 128          # Qwen2-MoE's fp32 decode vs forward
TINY_LEN = 256                # TinyLlama's prefill cache vs decode's
BF16_REL = 2 ** -6            # bf16 logits of two paths: max |d| over
                              # max |logit| (2 ulps at the largest logit)
FP32_ERR = 1e-3               # fp32 (TF32 off) decode vs forward logits
LOSS_ERR = 1e-3               # lm_loss vs a float64 cross-entropy
INT8_ERR = 0.15               # int8 vs exact decode, tests/test_kv_quant.py
MOE_ERR = 1e-5                # grouped vs token dispatch, fp32, the
                              # reference's tests/test_moe_grouped.py
# Qwen2-MoE's decode vs forward wants no drop in the forward: capacity
# factor n_experts / top_k makes C >= T, so no pair can drop (8.0, the
# reference's reduced_config value, dropped 1.0% and 2.9% of the pairs
# of layers 16 and 17 at full width: random weights route the tokens of
# deep layers alike)
KV_ERR = (0.25, 0.01)         # TinyLlama bf16 cache (and last logits: max
                              # only), prefill vs token by token: max and
                              # mean |d| (a few bf16 ulps at values up to 8,
                              # over 22 layers)


def _lm_free() -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _lm_tokens(cfg, B: int, S: int, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")


def _n_params(tree) -> int:
    return sum(_n_params(v) if isinstance(v, dict) else v.numel()
               for v in tree.values())


@contextlib.contextmanager
def moe_metrics():
    """Each ``moe_ffn`` call's metrics (one a MoE layer, in order)."""
    got, real = [], lm_moe.moe_ffn

    def spy(x, p, cfg):
        y, m = real(x, p, cfg)
        got.append(m)
        return y, m
    lm_moe.moe_ffn = spy
    try:
        yield got
    finally:
        lm_moe.moe_ffn = real


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _prefill_check(name, cfg, params, S: int, q_chunk: int, seed: int,
                   shapes: dict) -> dict:
    """``lm_prefill`` at B = 1 x S: time, tokens/s, cache shapes, finite
    logits; the cache is dropped before returning."""
    toks = _lm_tokens(cfg, 1, S, seed)
    step = rsteps.make_lm_prefill_step(cfg, q_chunk=q_chunk)
    (logits, cache), sec = _timed(lambda: step(params, toks))
    for f, want in shapes.items():
        got = tuple(getattr(cache, f).shape)
        if got != want:
            raise AssertionError(f"{name} prefill: cache {f} {got} != {want}")
    if logits.shape != (1, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"{name} prefill: logits {tuple(logits.shape)} "
                             f"not finite")
    if S == PREFILL_LEN:
        record_step(f"{name} prefill_32k", name, "prefill_32k", dict(
            global_batch=1, seq_len=S, q_chunk=q_chunk), sec,
            torch.cuda.max_memory_allocated(), 9)
    out = dict(prefill_s=sec, prefill_tok_per_s=S / sec,
               cache={f: list(v) for f, v in shapes.items()})
    log(f"{name} prefill B=1 x {S} (q_chunk {q_chunk}): {sec:.2f} s, "
        f"{S / sec:.0f} tokens/s; cache {out['cache']}; logits finite")
    del cache, logits
    return out


def _forward_vs_prefill(name, cfg, params, S: int, q_chunk: int,
                        seed: int) -> tuple:
    """``lm_forward`` and ``lm_prefill`` at B = 1 x S: the prefill's last
    logits against the forward's last row.  Returns (forward logits,
    tokens, max |d|, forward s)."""
    toks = _lm_tokens(cfg, 1, S, seed)
    fwd, sec = _timed(lambda: lm.lm_forward(params, toks, cfg, q_chunk))
    last, _ = lm.lm_prefill(params, toks, cfg, q_chunk)
    want = fwd[:, -1].float()
    err, scale = float((last - want).abs().max()), float(want.abs().max())
    if not torch.isfinite(last).all() or err > BF16_REL * scale:
        raise AssertionError(f"{name} prefill vs forward at S={S}: max |d| "
                             f"{err} over max |logit| {scale} (limit "
                             f"{BF16_REL} of it)")
    log(f"{name} forward B=1 x {S}: {sec:.2f} s ({S / sec:.0f} tokens/s); "
        f"prefill's last logits vs the forward's last row max |d| {err:.4g}")
    return fwd, toks, err, sec


def _decode_vs_forward(cfg, params, toks, fwd, quant_cfg=None) -> dict:
    """Decode ``toks`` one at a time and hold every step's logits against
    the forward's row (fp32: max |d| <= ``FP32_ERR``, every argmax
    equal); with ``quant_cfg`` an int8-cache decode runs in lockstep and
    is held against the exact one as tests/test_kv_quant.py holds it."""
    B, S = toks.shape
    dec = rsteps.make_lm_decode_step(cfg)
    cache = lm.init_decode_cache(cfg, B, S, device="cuda")
    want = fwd.argmax(-1)
    err = torch.zeros((), device="cuda")
    miss = torch.zeros((), dtype=torch.int64, device="cuda")
    if quant_cfg is not None:
        decq = rsteps.make_lm_decode_step(quant_cfg)
        cq = lm.init_decode_cache(quant_cfg, B, S, device="cuda")
        qerr = torch.zeros((), device="cuda")
        qagree = torch.zeros((), dtype=torch.int64, device="cuda")
    for t in range(S):
        nxt, logits, cache = dec(params, cache, toks[:, t:t + 1], t)
        err = torch.maximum(err, (logits - fwd[:, t]).abs().max())
        miss += (nxt[:, 0] != want[:, t]).sum()
        if quant_cfg is not None:
            nq, lq, cq = decq(params, cq, toks[:, t:t + 1], t)
            qerr = torch.maximum(qerr, (lq - logits).abs().max())
            qagree += (nq == nxt).sum()
    out = dict(steps=S, max_abs_err=float(err), argmax_misses=int(miss))
    if out["max_abs_err"] > FP32_ERR or out["argmax_misses"] or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"decode vs forward: {out} (limit {FP32_ERR}, "
                             f"every argmax equal)")
    if quant_cfg is not None:
        bytes_q = cq.k.nbytes + cq.k_sc.nbytes
        out.update(int8_max_abs_err=float(qerr),
                   int8_argmax_agree=int(qagree) / (B * S),
                   int8_last_argmax_equal=bool(torch.equal(nq, nxt)),
                   int8_bytes_ratio=bytes_q / cache.k.nbytes)
        if out["int8_max_abs_err"] >= INT8_ERR or \
                not out["int8_last_argmax_equal"] or \
                out["int8_bytes_ratio"] >= 0.6:
            raise AssertionError(f"int8 decode vs exact: {out} (limits "
                                 f"{INT8_ERR}, last argmax equal, bytes "
                                 f"< 0.6x)")
        if cq.k_loc is not None:
            out["int8_local_bytes_ratio"] = (
                (cq.k_loc.nbytes + cq.k_loc_sc.nbytes) / cache.k_loc.nbytes)
    return out


def lm_gemma(seed: int) -> dict:
    cfg = registry.get("gemma3-12b").config
    params = lm.init_lm(cfg, seed=seed, device="cuda")
    n_loc, n_glob = lm._n_local_global(cfg)
    out = dict(params=_n_params(params), layers=[n_loc, n_glob])
    log(f"gemma3-12b: {out['params']} parameters ({cfg.param_dtype}, "
        f"random from seed {seed}), {n_loc} local (window "
        f"{cfg.sliding_window}) + {n_glob} "
        f"global layers")
    D = (1, cfg.n_kv_heads, cfg.d_head)
    out.update(_prefill_check(
        "gemma3-12b", cfg, params, PREFILL_LEN, 256, seed,
        {"k": (n_glob, 1, PREFILL_LEN) + D[1:],
         "k_loc": (n_loc, 1, cfg.sliding_window) + D[1:]}))
    fwd, toks, out["prefill_vs_forward"], out["forward_s"] = \
        _forward_vs_prefill("gemma3-12b", cfg, params, TRAIN_LEN, 512, seed)
    loss = float(lm.lm_loss(params, toks, cfg, 512))
    ce = float(torch.nn.functional.cross_entropy(
        fwd[0, :-1].double(), toks[0, 1:]))
    out["loss"], out["loss_err"] = loss, abs(loss - ce)
    if not abs(loss - ce) <= LOSS_ERR:
        raise AssertionError(f"gemma3-12b lm_loss {loss} vs float64 "
                             f"cross-entropy {ce} (limit {LOSS_ERR})")
    del fwd
    torch.cuda.empty_cache()
    p = device_profile(lambda: lm.lm_forward(params, toks, cfg, 512),
                       warm=True)
    out["traced_forward"] = dict(wall_ms=p["wall_ms"], busy_ms=p["busy_ms"],
                                 idle=p["idle"], events=p["events"],
                                 top=p["top"])
    log(f"gemma3-12b lm_loss at S={TRAIN_LEN}: {loss:.6f}, float64 "
        f"cross-entropy of the forward's logits off by {out['loss_err']:.3g}"
        f"; traced forward: wall {p['wall_ms']:.1f} ms, device busy "
        f"{p['busy_ms']:.1f} ms ({100 * p['idle']:.0f}% idle), "
        f"{p['events']} device events; top: " + top_ops(p, 2))
    del params, p
    _lm_free()
    # past the window: one group's depth (5 local + 1 global) in fp32
    cfg6 = dataclasses.replace(cfg, n_layers=cfg.local_global_ratio + 1,
                               param_dtype="float32",
                               compute_dtype="float32")
    params = lm.init_lm(cfg6, seed=seed, device="cuda")
    S = cfg.sliding_window + 64       # the ring wraps once
    toks = _lm_tokens(cfg6, 1, S, seed + 1)
    fwd = lm.lm_forward(params, toks, cfg6, q_chunk=S // 2)
    (dec, sec) = _timed(lambda: _decode_vs_forward(
        cfg6, params, toks, fwd,
        dataclasses.replace(cfg6, kv_quant=True)))
    out["past_window"] = dict(dec, seconds=sec, layers=cfg6.n_layers)
    log(f"gemma3-12b past the window (fp32, TF32 off, {cfg6.n_layers} "
        f"layers, {S} tokens, ring of {cfg.sliding_window}): decode vs "
        f"forward max |d| {dec['max_abs_err']:.3g} (limit {FP32_ERR}), "
        f"every argmax equal; int8 cache max |d| vs exact "
        f"{dec['int8_max_abs_err']:.4g} (limit {INT8_ERR}), argmax agrees "
        f"at {100 * dec['int8_argmax_agree']:.2f}% of steps, last equal, "
        f"global cache bytes {dec['int8_bytes_ratio']:.3f}x and local "
        f"{dec['int8_local_bytes_ratio']:.3f}x the exact fp32 cache's; "
        f"{sec:.1f} s for 2 x {S} steps")
    del params, fwd
    return out


def _to_fp32_in_place(tree) -> None:
    """Widen every leaf to fp32 one at a time (a stacked bf16 leaf is
    freed before the next is widened)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _to_fp32_in_place(v)
        else:
            tree[k] = v.float()
            del v
            torch.cuda.empty_cache()


def lm_qwen(seed: int) -> dict:
    cfg = registry.get("qwen2-moe-a2.7b").config
    params = lm.init_lm(cfg, seed=seed, device="cuda")
    out = dict(params=_n_params(params))
    log(f"qwen2-moe-a2.7b: {out['params']} parameters ({cfg.param_dtype}, "
        f"random from seed {seed}), {cfg.n_layers} layers of "
        f"{cfg.n_experts} routed "
        f"experts top {cfg.moe_top_k} + {cfg.n_shared_experts} shared; "
        f"router {params['layers']['moe']['router'].dtype}")
    with moe_metrics() as got:
        out.update(_prefill_check(
            "qwen2-moe-a2.7b", cfg, params, PREFILL_LEN, 256, seed,
            {"k": (cfg.n_layers, 1, PREFILL_LEN, cfg.n_kv_heads,
                   cfg.d_head)}))
    out["prefill_drop_fraction"] = [float(m["drop_fraction"]) for m in got]
    with moe_metrics() as got:
        fwd, toks, out["prefill_vs_forward"], out["forward_s"] = \
            _forward_vs_prefill("qwen2-moe-a2.7b", cfg, params, TRAIN_LEN,
                                512, seed)
    drops = [float(m["drop_fraction"]) for m in got[:cfg.n_layers]]
    out["forward_drop_fraction"] = drops
    log(f"qwen2-moe-a2.7b drop_fraction by layer (capacity factor "
        f"{cfg.capacity_factor}): prefill S={PREFILL_LEN} "
        f"{[round(d, 4) for d in out['prefill_drop_fraction']]}; forward "
        f"S={TRAIN_LEN} {[round(d, 4) for d in drops]}")
    del fwd
    # one layer's grouped dispatch against the token path, group by group,
    # in fp32 at full width (the reference's tests/test_moe_grouped.py form)
    layer = lm.cast_layer(lm.unbind_layers(params["layers"])[0],
                          torch.float32)["moe"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(4, 1024, cfg.d_model, generator=gen, device="cuda")
    y, m = lm_moe.moe_ffn(x, layer, cfg)
    err, scale = 0.0, float(y.abs().max())
    for g in range(4):
        want = lm_moe._moe_ffn_tokens(x[g], layer, cfg)[0]
        err = max(err, float((want - y[g]).abs().max()))
        if not torch.allclose(y[g], want, rtol=MOE_ERR, atol=MOE_ERR):
            raise AssertionError(f"qwen2-moe-a2.7b grouped vs token "
                                 f"dispatch, group {g}: max |d| {err} "
                                 f"(rtol = atol = {MOE_ERR})")
    out["grouped_vs_tokens"] = err
    log(f"qwen2-moe-a2.7b layer 0 grouped dispatch [4, 1024, "
        f"{cfg.d_model}] vs the token path group by group (fp32): max |d| "
        f"{err:.3g} (max |y| {scale:.3g}); drop_fraction "
        f"{float(m['drop_fraction']):.4f}")
    del layer, x, y
    # decode vs forward in fp32, at a capacity no pair can exceed
    _to_fp32_in_place(params)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32",
                                capacity_factor=cfg.n_experts / cfg.moe_top_k)
    toks = _lm_tokens(cfg32, 1, MOE_DECODE_LEN, seed + 1)
    with moe_metrics() as got:
        fwd = lm.lm_forward(params, toks, cfg32, q_chunk=MOE_DECODE_LEN)
    drops = [float(m["drop_fraction"]) for m in got]
    if any(drops):
        raise AssertionError(f"qwen2-moe-a2.7b fp32 forward dropped tokens "
                             f"at capacity factor {cfg32.capacity_factor}: "
                             f"{drops}")
    dec, sec = _timed(lambda: _decode_vs_forward(cfg32, params, toks, fwd))
    out["decode_vs_forward"] = dict(dec, seconds=sec)
    log(f"qwen2-moe-a2.7b decode vs forward (fp32, TF32 off, capacity "
        f"factor {cfg32.capacity_factor}, nothing dropped, {cfg.n_layers} "
        f"layers): "
        f"{MOE_DECODE_LEN} steps, "
        f"max |d| {dec['max_abs_err']:.3g} (limit {FP32_ERR}), every argmax "
        f"equal, {sec:.1f} s")
    del params, fwd
    return out


def lm_grok(seed: int) -> dict:
    full = registry.get("grok-1-314b").config
    cfg = dataclasses.replace(full, n_layers=2)   # depth cut: one card
    params = lm.init_lm(cfg, seed=seed, device="cuda")
    out = dict(params=_n_params(params), full_params=full.param_count,
               layers=[cfg.n_layers, full.n_layers])
    log(f"grok-1-314b at its widths, {cfg.n_layers} of {full.n_layers} "
        f"layers: {out['params']} parameters ({cfg.param_dtype}, random "
        f"from seed {seed}; the full model {full.param_count})")
    S = GROK_LEN
    with moe_metrics() as got:
        out.update(_prefill_check(
            "grok-1-314b", cfg, params, S, 128, seed,
            {"k": (cfg.n_layers, 1, S, cfg.n_kv_heads, cfg.d_head)}))
        fwd, _, out["prefill_vs_forward"], out["forward_s"] = \
            _forward_vs_prefill("grok-1-314b", cfg, params, S, 128, seed)
    out["drop_fraction"] = [round(float(m["drop_fraction"]), 4)
                            for m in got]
    log(f"grok-1-314b drop_fraction by layer (prefill, forward, prefill): "
        f"{out['drop_fraction']}")
    del params, fwd
    return out


def lm_tinyllama(seed: int) -> dict:
    """The prefill's bf16 cache of 256 tokens against the dense decode's
    (the paged path's oracle) built token by token."""
    cfg = registry.get("tinyllama-1.1b").config
    params = lm.init_lm(cfg, seed=seed, device="cuda")
    S = TINY_LEN
    toks = _lm_tokens(cfg, 2, S, seed)
    logits, pre = lm.lm_prefill(params, toks, cfg, q_chunk=S)
    cache = lm.init_decode_cache(cfg, 2, S, device="cuda")
    for t in range(S):
        last, cache = lm.lm_decode_step(params, cache, toks[:, t:t + 1], t,
                                        cfg)
    out = {}
    for f in ("k", "v"):
        d = (getattr(pre, f).float() - getattr(cache, f).float()).abs()
        out[f] = (float(d.max()), float(d.mean()))
        if out[f][0] > KV_ERR[0] or out[f][1] > KV_ERR[1]:
            raise AssertionError(f"tinyllama-1.1b prefill vs decode cache "
                                 f"{f}: max / mean |d| {out[f]} (limits "
                                 f"{KV_ERR})")
    out["logits"] = float((logits - last).abs().max())
    if out["logits"] > KV_ERR[0]:
        raise AssertionError(f"tinyllama-1.1b prefill vs decode last "
                             f"logits: max |d| {out['logits']} (limit "
                             f"{KV_ERR[0]})")
    log(f"tinyllama-1.1b: bf16 cache of 2 x {S} tokens, lm_prefill vs the "
        f"dense decode token by token: k max / mean |d| {out['k'][0]:.4g} / "
        f"{out['k'][1]:.3g}, v {out['v'][0]:.4g} / {out['v'][1]:.3g} "
        f"(limits {KV_ERR}); last logits max |d| {out['logits']:.4g} (limit "
        f"{KV_ERR[0]})")
    del params, pre, cache
    return out


def phase_lm(seed: int) -> dict:
    """Phase 9: one arch on the card at a time, everything freed before
    each; returns each arch's seconds, peak memory and checks."""
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, fn in (("gemma3-12b", lm_gemma), ("qwen2-moe-a2.7b", lm_qwen),
                     ("grok-1-314b", lm_grok),
                     ("tinyllama-1.1b", lm_tinyllama)):
        _lm_free()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        r = fn(seed)
        torch.cuda.synchronize()
        r.update(seconds=time.perf_counter() - t0,
                 peak_bytes=torch.cuda.max_memory_allocated(),
                 held_before=held)
        out[name] = r
        log(f"{name}: {r['seconds']:.1f} s, peak device memory "
            f"{r['peak_bytes'] / 2**30:.2f} GiB ({held} bytes held before)")
    _lm_free()
    return out


# ---------------------------------------------------------------------------
# Phase 10: training
# ---------------------------------------------------------------------------
BWD_ERR = 1e-5        # backward vs plain on rows of many contributions:
                      # |d| over the row's summed |contributions| (fp32
                      # sum order; the plain version's atomics take any)
TRAIN_RTOL = 1e-5     # card vs CPU: loss, parameters (and atol), and the
                      # moments (atol: 1e-5 x the leaf's largest moment)
GNORM_RTOL = 1e-4     # card vs CPU grad_norm
TRAIN_LEN = 4096      # train_4k's sequence length
TINY_TRAIN_B = 8      # sequences a TinyLlama step (cut from train_4k's 256)
DCN_STEPS, DCN_SAVE, DCN_FAIL = 6, 2, 5
DCN_TRACED = 3        # the uninterrupted DCN-v2 run's traced step
LM_RESTART = ("--arch", "tinyllama-1.1b", "--steps", "12", "--save-every",
              "4", "--log-every", "4")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({4: torch.int32, 2: torch.int16, 1: torch.int8}[
        t.element_size()])


def _bit_equal(a, b) -> bool:
    return all(torch.equal(_bits(x), _bits(y))
               for x, y in zip(ttree.leaves(a), ttree.leaves(b)))


def check_bwd(name, g, idx, off, mode, R, dtype) -> float:
    """The kernel twice (bit-equal run to run) against its order in plain
    torch (``tbwd.in_order_backward``: bit-equal) and its plain version on
    the card: rows of one contribution bit-equal, untouched rows zero,
    the rest within ``BWD_ERR`` of the row's summed |contributions| (a
    bf16 table: plus one bf16 ulp of the plain value).  Returns the max
    absolute difference from the plain version."""
    got = ops.embedding_bag_backward(g, idx, off, mode, R, dtype)
    again = ops.embedding_bag_backward(g, idx, off, mode, R, dtype)
    torch.cuda.synchronize()
    if got.shape != (R, g.shape[1]) or got.dtype != dtype:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)}")
    if not torch.equal(_bits(got), _bits(again)):
        raise AssertionError(f"{name}: two calls differ")
    del again
    if not torch.equal(_bits(got), _bits(tbwd.in_order_backward(
            g, idx, off, mode, R, dtype))):
        raise AssertionError(f"{name}: differs from the in-order sum")
    want = ref.embedding_bag_backward_ref(g, idx, off, mode, R, dtype)
    pos = torch.arange(idx.numel(), device="cuda")
    inside = (pos >= off[0]) & (pos < off[-1])
    cnt = torch.bincount(idx.long().clamp(0, R - 1)[inside], minlength=R)
    one, none = cnt == 1, cnt == 0
    if not torch.equal(_bits(got[one]), _bits(want[one])):
        raise AssertionError(f"{name}: a row of one contribution differs "
                             f"from the plain version")
    if bool((got[none] != 0).any()):
        raise AssertionError(f"{name}: an untouched row is not zero")
    many = cnt > 1
    mag = ref.embedding_bag_backward_ref(g.abs(), idx, off, mode, R,
                                         torch.float32)[many]
    d = (got[many].float() - want[many].float()).abs()
    slack = 2 ** -7 * want[many].float().abs() if dtype == torch.bfloat16 \
        else 0.0           # one bf16 ulp: the two fp32 sums may round apart
    if not torch.isfinite(got).all() or bool((d > BWD_ERR * mag + slack)
                                             .any()):
        raise AssertionError(f"{name}: beyond {BWD_ERR} of the summed "
                             f"magnitudes")
    rel = float((d / mag.clamp(min=1e-30)).max()) if d.numel() else 0.0
    err = float(d.max()) if d.numel() else 0.0
    log(f"embedding_bag_backward {name}: {g.shape[0]} bags, {idx.numel()} "
        f"positions, {int(one.sum())} rows of one contribution bit-equal, "
        f"{int(many.sum())} of many (at most {int(cnt.max())}): max abs err "
        f"{err:.3g}, {rel:.3g} of the summed magnitudes; bit-equal run to "
        f"run and to the in-order sum")
    return err


def check_bwd_widths(seed: int) -> int:
    """The kernel at every lane width and row layout the launch takes
    (``tbwd.width_cases``: D 1, 2, 10, 18 and 16 at an odd address, fp32
    and bf16, sum and mean, whole and in three windows, a run over 68
    chunks): each call twice, bit-equal run to run and to
    ``tbwd.in_order_backward``; the windows concatenated bit-equal to the
    whole.  Returns the calls checked."""
    whole = {}
    cases = tbwd.width_cases(seed)
    for name, g, idx, off, mode, R, dtype, lo, hi in cases:
        got = ops.embedding_bag_backward(g, idx, off, mode, R, dtype,
                                         row_lo=lo, row_hi=hi)
        again = ops.embedding_bag_backward(g, idx, off, mode, R, dtype,
                                           row_lo=lo, row_hi=hi)
        if not torch.equal(_bits(got), _bits(again)) or not torch.equal(
                _bits(got), _bits(tbwd.in_order_backward(
                    g, idx, off, mode, R, dtype, row_lo=lo, row_hi=hi))):
            raise AssertionError(f"embedding_bag_backward {name}: not "
                                 f"bit-equal to the in-order sum")
        whole.setdefault((g.shape[1], dtype, mode), []).append(got)
    for key, parts in whole.items():
        if not torch.equal(_bits(torch.cat(parts[1:])), _bits(parts[0])):
            raise AssertionError(f"embedding_bag_backward {key}: windows "
                                 f"differ from the whole")
    torch.cuda.synchronize()
    log(f"embedding_bag_backward at every lane width: {len(cases)} calls "
        f"(D 1, 2, 10, 18, 16 at an odd address; fp32 and bf16; sum and "
        f"mean; whole and three windows) bit-equal to the in-order sum, "
        f"run to run, windows to the whole")
    return len(cases)


def bwd_timing(case) -> dict:
    """The wrapper (plan and kernels) warm, L2-flushed and by the
    profiler, beside its plain version, the library call and the bound:
    the dense d_table write and one read of grad_out, the indices and the
    offsets."""
    name, g, idx, off, mode, R, dtype = case
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def kernel():
        return ops.embedding_bag_backward(g, idx, off, mode, R, dtype)
    lens = (off[1:] - off[:-1]).long()
    rows = idx.long().clamp(0, R - 1)[int(off[0]):int(off[-1])]
    n = rows.numel()

    def library():
        return torch.zeros(R, g.shape[1], dtype=torch.float32,
                           device="cuda").index_add_(
            0, rows, g.repeat_interleave(lens, dim=0, output_size=n))
    esize = torch.empty((), dtype=dtype).element_size()
    need = R * g.shape[1] * esize + g.numel() * 4 + idx.numel() * 4 + \
        off.numel() * 4
    prof = device_profile(kernel, warm=True)
    row = dict(ms=cuda_ms_cold(kernel, flush), ms_warm=cuda_ms(kernel),
               device_ms=prof["busy_ms"],
               plain_ms=cuda_ms_cold(lambda: ref.embedding_bag_backward_ref(
                   g, idx, off, mode, R, dtype), flush),
               library_ms=cuda_ms_cold(library, flush), bytes=need,
               bound_ms=need / HBM_BYTES_PER_S * 1e3)
    log(f"kernel embedding_bag_backward at {name} ({g.shape[0]} bags, "
        f"{idx.numel()} positions, R {R}, D {g.shape[1]}, {dtype}): "
        f"{row['ms_warm']:.4f} ms warm, {row['ms']:.4f} flushed, "
        f"{row['device_ms']:.4f} device by the profiler ({top_ops(prof, 4)});"
        f" plain {row['plain_ms']:.4f} ms, library (zeros + index_add_ of "
        f"repeat_interleave) {row['library_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({need} bytes)")
    return row


def lm_launcher_restart(tmp: str) -> dict:
    """(b) ``launch/train.py``'s ``main`` (the smoke preset) crashed at
    ``--fail-at 9``, rerun with ``--resume``, and run uninterrupted from
    scratch, in one subprocess: on the card the launcher runs in
    deterministic mode with cuBLAS's fixed workspace, which must be set
    before cuBLAS starts, and no other phase runs in that mode (a process
    takes about 17 s to start on the card): the step-12 checkpoints
    (every parameter and moment) and the final losses bit-equal."""
    env = dict(os.environ,
               PYTHONPATH=_SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    crash, clean = os.path.join(tmp, "crash"), os.path.join(tmp, "clean")
    args = list(LM_RESTART)
    code = (
        "import sys\n"
        "from repro_torch.launch import train\n"
        "try:\n"
        f"    train.main({args + ['--ckpt-dir', crash, '--fail-at', '9']!r})\n"
        "    sys.exit('no injected failure')\n"
        "except SystemExit as e:\n"
        "    print(f'crashed: {e}')\n"
        f"train.main({args + ['--ckpt-dir', crash, '--resume']!r})\n"
        f"train.main({args + ['--ckpt-dir', clean]!r})\n")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if p.returncode or "crashed: injected failure at step 9" not in \
            p.stdout or "resumed from step 8" not in p.stdout:
        raise AssertionError(f"train launcher: rc {p.returncode}\n"
                             f"{p.stdout}\n{p.stderr}")
    got = []
    for d in (clean, crash):
        with np.load(os.path.join(d, "step_00000012.npz")) as z:
            got.append({k: z[k].tobytes() for k in z.files})
        with open(os.path.join(d, "MANIFEST.json")) as fh:
            got.append(json.load(fh)["extra"]["loss"])
    if got[0] != got[2] or got[1] != got[3]:
        raise AssertionError("train launcher: the resumed run's step-12 "
                             "checkpoint or loss differs from the "
                             "uninterrupted run's")
    log(f"train launcher (smoke preset, a subprocess): crash "
        f"at step 9, resume from step 8: the step-12 parameters and moments "
        f"({len(got[0])} leaves) and the final loss {got[1]!r} bit-equal to "
        f"the uninterrupted run; {seconds:.1f} s")
    return dict(loss=got[1], leaves=len(got[0]), seconds=seconds)


def dcn_batches(cfg, B: int, n: int, seed: int) -> list:
    spec = dataclasses.replace(registry.get_shape("dcn-v2", "train_batch"),
                               global_batch=B)
    out = []
    for s in range(n):
        rng = np.random.default_rng([seed, s])
        b = recsys_batch(cfg, spec, rng)
        b["label"] = torch.as_tensor(rng.integers(0, 2, B),
                                     dtype=torch.float32, device="cuda")
        out.append(b)
    return out


def dcn_train(tmp: str, seed: int) -> dict:
    """(b) and (d) for DCN-v2 as published (fp32, the 33,762,816 x 16
    table) at train_batch (B 65,536) through ``TrainLoopRunner``: an
    uninterrupted run of 6 steps (each timed, step 3 traced, launches
    counted), then a run saving every 2 steps that fails at step 5 and is
    resumed from step 4 (the resumed steps save nothing: 6.07 GiB a
    file): every parameter and moment bit-equal to the uninterrupted
    run's.  The path's determinism is the bag kernels':
    this runs without deterministic mode."""
    cfg = registry.get("dcn-v2").config
    entry = registry.get("dcn-v2")
    B = registry.get_shape("dcn-v2", "train_batch").global_batch
    batches = dcn_batches(cfg, B, DCN_STEPS, seed)
    opt = toptim.AdamW()
    step = rsteps.make_recsys_train_step(cfg, opt)
    times, losses, traced = [], [], {}

    def step_fn(p, s, b):
        """One step, timed (``DCN_TRACED``: under the profiler)."""
        if len(times) == DCN_TRACED:
            traced.update(device_profile(lambda: step(p, s, b)))
            out, dt = traced.pop("out"), traced["wall_ms"] / 1e3
        else:
            out, dt = _timed(lambda: step(p, s, b))
        times.append(dt)
        losses.append(float(out[2]["loss"]))
        return out

    params = rsteps.init_params_for(entry, cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    runner = telastic.TrainLoopRunner(step_fn, tckpt.CheckpointManager(
        os.path.join(tmp, "dcn-clean")), save_every=DCN_STEPS + 1)
    _, p_clean, s_clean = runner.run(params, opt.init(params), batches)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    del params
    if counts["embedding_bag"] != DCN_STEPS or \
            counts["embedding_bag_backward"] != DCN_STEPS:
        raise AssertionError(f"dcn-v2 training: launches {counts}, expected "
                             f"{DCN_STEPS} of each bag kernel")
    t_ckpt = time.perf_counter()
    params = rsteps.init_params_for(entry, cfg, seed=seed, device="cuda")
    mgr = tckpt.CheckpointManager(os.path.join(tmp, "dcn-crash"), keep=2)
    runner = telastic.TrainLoopRunner(step, mgr, save_every=DCN_SAVE)
    try:
        runner.run(params, opt.init(params), batches, fail_at=DCN_FAIL)
        raise AssertionError("dcn-v2: no injected failure")
    except RuntimeError as e:
        if "injected failure at step 5" not in str(e):
            raise
    start, p, s = runner.resume(params, opt.init(params))
    del params
    runner.save_every = DCN_STEPS + 1   # the check needs no step-6 file
    _, p_crash, s_crash = runner.run(p, s, batches[start:],
                                     start_step=start)
    torch.cuda.synchronize()
    t_ckpt = time.perf_counter() - t_ckpt
    if not all(np.isfinite(losses)) or start != 4 or not _bit_equal((p_clean, s_clean), (p_crash, s_crash)):
        raise AssertionError(f"dcn-v2: resumed from {start}; the resumed "
                             f"run's state differs from the uninterrupted "
                             f"run's")
    state_bytes = sum(t.numel() * t.element_size()
                      for t in ttree.leaves((p_clean, s_clean)))
    med = float(np.median(times[1:]))
    record_step("dcn-v2 train_batch", "dcn-v2", "train_batch", {}, med, peak,
                10)
    out = dict(step_s=times, median_s=med, samples_per_s=B / med,
               peak_bytes=peak, launches=counts, idle=traced["idle"],
               traced_ms=traced["wall_ms"], busy_ms=traced["busy_ms"],
               top=top_ops(traced, 3), restart_s=t_ckpt,
               state_bytes=state_bytes, losses=losses)
    log(f"dcn-v2 training (fp32, table {rmodels.padded_rows(cfg.total_rows)}"
        f" x {cfg.embed_dim}, B {B}): steps "
        f"{', '.join(f'{t:.4f}' for t in times)} s (step {DCN_TRACED + 1} "
        f"traced), median {med:.4f} s, {B / med:.0f} samples/s; peak "
        f"{peak / 2**30:.2f} GiB; bag launches a step: forward "
        f"{counts['embedding_bag'] // DCN_STEPS}, backward "
        f"{counts['embedding_bag_backward'] // DCN_STEPS}; traced step "
        f"{traced['wall_ms']:.2f} ms wall, {traced['busy_ms']:.2f} ms device"
        f", idle {traced['idle']:.3f}; top ops {out['top']}; loss "
        f"{', '.join(f'{x:.5f}' for x in losses)}")
    log(f"dcn-v2 exact restart: fail at step {DCN_FAIL}, resumed from step "
        f"{start} (saves every {DCN_SAVE}; {state_bytes / 2**30:.2f} GiB of "
        f"state a checkpoint): every parameter and moment bit-equal to the "
        f"uninterrupted run; {t_ckpt:.1f} s for the crashed run, its "
        f"checkpoints and the resume")
    del p_clean, s_clean, p_crash, s_crash, p, s
    return out


def _allclose_tree(name, got, want, leaf_scale: bool,
                   tol: float = TRAIN_RTOL) -> float:
    """Leaves of ``got`` (card) against ``want`` (CPU): within
    ``TRAIN_RTOL`` relative, absolute ``tol`` (``leaf_scale``: times the
    leaf's largest |want|); returns the worst |d|."""
    worst = 0.0
    for (path, g), w in zip(ttree.items_with_path(got), ttree.leaves(want)):
        g, w = g.cpu().float(), w.float()
        atol = tol * (float(w.abs().max()) if leaf_scale else 1.0)
        d = (g - w).abs()
        if bool((d > atol + TRAIN_RTOL * w.abs()).any()):
            raise AssertionError(f"{name} {'/'.join(path)}: max |d| "
                                 f"{float(d.max()):.3g} (atol {atol:.3g})")
        worst = max(worst, float(d.max()))
    return worst


def _card_vs_cpu(name, make_step, params_cpu, batch_cpu, metrics) -> dict:
    """One step of the same train step on the CPU and on the card from
    the same parameters and batch."""
    to = lambda t: t.to("cuda")                          # noqa: E731
    opt = toptim.AdamW()
    params_gpu = ttree.tree_map(to, params_cpu)
    step = make_step(opt)
    pc, sc, mc = step(params_cpu, opt.init(params_cpu), batch_cpu)
    pg, sg, mg = step(params_gpu, opt.init(params_gpu),
                      {k: to(v) for k, v in batch_cpu.items()}
                      if isinstance(batch_cpu, dict) else to(batch_cpu))
    torch.cuda.synchronize()
    out = {}
    for k in metrics:
        c, g = float(mc[k]), float(mg[k])
        tol = GNORM_RTOL if k == "grad_norm" else TRAIN_RTOL
        if not abs(g - c) <= tol * abs(c):
            raise AssertionError(f"{name} {k}: card {g!r}, CPU {c!r}")
        out[k] = (g, c)
    out["params_max_d"] = _allclose_tree(name + " params", pg, pc, False)
    out["mu_max_d"] = _allclose_tree(name + " mu", sg.mu, sc.mu, True)
    out["nu_max_d"] = _allclose_tree(name + " nu", sg.nu, sc.nu, True)
    return out


def train_card_vs_cpu(seed: int) -> dict:
    """(c) TinyLlama-1.1B's widths at 2 layers in fp32, 2 x 256 tokens, 2
    microbatches; the four recsys archs at ``reduced_config`` (B 64): one
    AdamW step (the reference's defaults) on the card against the port on
    the CPU."""
    out = {}
    cfg = dataclasses.replace(registry.get("tinyllama-1.1b").config,
                              n_layers=2, param_dtype="float32",
                              compute_dtype="float32")
    params = lm.init_lm(cfg, seed=seed, device="cpu")
    toks = tlm_data.make_batch_fn(tlm_data.LMDataConfig(
        vocab=cfg.vocab, batch=2, seq_len=256), device="cpu")(0)
    out["tinyllama-1.1b/2 layers"] = _card_vs_cpu(
        "tinyllama-1.1b 2 layers fp32", lambda opt: rsteps.make_lm_train_step(
            cfg, opt, n_microbatches=2, q_chunk=128), params, toks,
        ("loss", "grad_norm"))
    del params
    for arch, _, _ in RECSYS_CELLS:
        rcfg = registry.reduced_config(arch)
        params = rsteps.init_params_for(registry.get(arch), rcfg, seed=seed,
                                        device="cpu")
        spec = dataclasses.replace(registry.get_shape(arch, "train_batch"),
                                   global_batch=64)
        rng = np.random.default_rng(seed)
        b = recsys_batch(rcfg, spec, rng, "cpu")
        b["label"] = torch.as_tensor(rng.integers(0, 2, 64),
                                     dtype=torch.float32)
        out[arch] = _card_vs_cpu(
            f"{arch} reduced", lambda opt, c=rcfg:
            rsteps.make_recsys_train_step(c, opt), params, b, ("loss",))
    log("train steps, card vs CPU (one AdamW step, TF32 off): " +
        json.dumps(out))
    return out


def lm_train(name: str, cfg, B: int, n_micro: int, steps: int, seed: int,
             traced: bool) -> dict:
    """``steps`` train steps of ``cfg`` at ``B`` x ``TRAIN_LEN`` tokens
    from ``data/lm_data.py`` (remat on, AdamW's defaults), each timed;
    the last traced when ``traced``; loss and grad_norm finite."""
    _lm_free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=seed, device="cuda")
    opt = toptim.AdamW()
    state = opt.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = rsteps.make_lm_train_step(cfg, opt, n_microbatches=n_micro,
                                     q_chunk=512)
    batch_at = tlm_data.make_batch_fn(tlm_data.LMDataConfig(
        vocab=cfg.vocab, batch=B, seq_len=TRAIN_LEN, seed=seed),
        device="cuda")
    times, metrics, prof = [], [], None
    for i in range(steps):
        toks = batch_at(i)
        if traced and i == steps - 1:
            prof = device_profile(lambda: step(params, state, toks))
            params, state, m = prof["out"]
            times.append(prof["wall_ms"] / 1e3)
        else:
            (params, state, m), dt = _timed(lambda: step(params, state,
                                                         toks))
            times.append(dt)
        metrics.append({k: float(v) for k, v in m.items()})
        if not all(np.isfinite(v) for v in metrics[-1].values()):
            raise AssertionError(f"{name}: step {i} metrics {metrics[-1]}")
    peak = torch.cuda.max_memory_allocated()
    n = _n_params(params)
    # tokens/s over the untraced steps after the first (which warms the
    # allocator and cuBLAS), or the one step there is
    plain = times[1:-1] if traced else times[1:]
    step_s = float(np.median(plain)) if plain else times[0]
    if name == "tinyllama-1.1b":
        record_step("tinyllama-1.1b train_4k", name, "train_4k", dict(
            global_batch=B, seq_len=TRAIN_LEN, n_microbatches=n_micro,
            q_chunk=512), step_s, peak, 10)
    out = dict(layers=cfg.n_layers, params=n, batch=B, seq=TRAIN_LEN,
               n_micro=n_micro, init_s=init_s, step_s=times,
               tokens_per_s=B * TRAIN_LEN / step_s, metrics=metrics,
               peak_bytes=peak)
    msg = (f"{name} training ({cfg.n_layers} layers, {n / 1e9:.2f}B params, "
           f"{cfg.param_dtype}, B {B} x {TRAIN_LEN}, {n_micro} microbatches,"
           f" remat {cfg.remat}): init {init_s:.1f} s; steps "
           f"{', '.join(f'{t:.3f}' for t in times)} s"
           + (" (the last traced)" if traced else "")
           + f"; {out['tokens_per_s']:.0f} tokens/s at {step_s:.3f} s a step;"
           f" loss "
           f"{', '.join(str(round(m['loss'], 4)) for m in metrics)}; "
           f"grad_norm {', '.join(str(round(m['grad_norm'], 4)) for m in metrics)}"
           f"; peak {peak / 2**30:.2f} GiB")
    if prof is not None:
        out.update(idle=prof["idle"], busy_ms=prof["busy_ms"],
                   events=prof["events"], top=top_ops(prof))
        msg += (f"; traced step {prof['wall_ms']:.1f} ms wall, "
                f"{prof['busy_ms']:.1f} ms device, idle {prof['idle']:.3f}, "
                f"{prof['events']} device events; top ops {out['top']}")
    log(msg)
    del params, state
    _lm_free()
    return out


def phase_train(seed: int) -> dict:
    """Phase 10; returns the embedding_bag_backward kernel row and the
    phase's results."""
    _lm_free()
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cases = tbwd.bwd_cases(seed)
    err = max(check_bwd(*c) for c in cases)
    check_bwd_widths(seed)
    timing = bwd_timing(cases[0])
    del cases
    _lm_free()
    res = dict(kernel_s=time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tmp:
        res["launcher"] = lm_launcher_restart(tmp)
        res["dcn-v2"] = dcn_train(tmp, seed)
    _lm_free()
    res["card_vs_cpu"] = train_card_vs_cpu(seed)
    tiny = registry.get("tinyllama-1.1b").config
    res["tinyllama-1.1b"] = lm_train("tinyllama-1.1b", tiny, TINY_TRAIN_B, 2,
                                     3, seed, traced=True)
    qwen = dataclasses.replace(registry.get("qwen2-moe-a2.7b").config,
                               n_layers=2)
    res["qwen2-moe-a2.7b"] = lm_train("qwen2-moe-a2.7b (2 of 24 layers)",
                                      qwen, 2, 1, 1, seed, traced=False)
    gemma = dataclasses.replace(registry.get("gemma3-12b").config,
                                n_layers=6)
    res["gemma3-12b"] = lm_train("gemma3-12b (one 5 local + 1 global group)",
                                 gemma, 1, 1, 1, seed, traced=False)
    launches = res["dcn-v2"]["launches"]["embedding_bag_backward"]
    row = dict(name="embedding_bag_backward", route="cuda",
               source=SOURCES["embedding_bag_backward"],
               replaces=REPLACES["embedding_bag_backward"],
               launches=launches, path="train", max_abs_err=err,
               ms=timing["ms"], plain_ms=timing["plain_ms"],
               bound_ms=timing["bound_ms"], bound_by="bytes",
               library_ms=timing["library_ms"])
    res["kernel"] = timing
    return row, res


# ---------------------------------------------------------------------------
# Phase 11: SchNet and the GNN train step
# ---------------------------------------------------------------------------
GNN_TOL = 1e-5        # card vs CPU: outputs, loss and parameters (relative
                      # and absolute)
GNN_MOMENT_TOL = 1e-4  # card vs CPU moments: times the leaf's largest (the
                      # E messages and N node outputs sum in other orders)
GNN_EPS = 1e-6        # AdamW's eps in (a): at the default 1e-8 Adam divides
                      # the gradients' summation noise by itself where they
                      # reach 1e-9 (tests/test_torch_gnn_steps.py)
GNN_STEPS = 5         # train steps of each cell, the last traced
REDDIT_NODES, REDDIT_DEGREE = 232_965, 492   # minibatch_lg's graph:
                      # random_graph's n x avg_degree = 114,618,780 edges
                      # (the shape's 114,615,892 is not a multiple of n)
MOLECULE_ATOMS = (1, 6, 7, 8, 9)   # H, C, N, O, F: QM9's elements


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the phase: the
    scatter-add (``index_add_``) and the gather's gradient take their
    sorted, atomic-free CUDA paths.  cuBLAS's fixed workspace
    (``CUBLAS_WORKSPACE_CONFIG``) can only be set before cuBLAS starts,
    which in this script is phase 5, so its check only warns; the GEMMs
    run on one stream, and (d) checks the bits."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def gnn_graph(rng, n_nodes: int, n_edges: int, d_feat: int) -> dict:
    """A featureful graph on the CPU: uniform edges, normal features,
    edge distances uniform in [0, 10), one graph and one target."""
    return dict(
        node_feat=torch.as_tensor(rng.normal(size=(n_nodes, d_feat)),
                                  dtype=torch.float32),
        src=torch.as_tensor(rng.integers(0, n_nodes, n_edges),
                            dtype=torch.int32),
        dst=torch.as_tensor(rng.integers(0, n_nodes, n_edges),
                            dtype=torch.int32),
        edge_dist=torch.as_tensor(rng.uniform(0, 10, n_edges),
                                  dtype=torch.float32),
        graph_id=torch.zeros(n_nodes, dtype=torch.int32),
        targets=torch.as_tensor(rng.normal(size=1), dtype=torch.float32))


def gnn_card_vs_cpu(name: str, cfg, batch: dict, seed: int) -> dict:
    """(a) The same weights (drawn on the CPU) and graph on the card and
    on the port's CPU path: per-node outputs, readout and loss within
    ``GNN_TOL``, then one AdamW step (eps ``GNN_EPS``): loss and
    parameters within ``GNN_TOL``, moments within ``GNN_MOMENT_TOL`` of
    each leaf's largest."""
    d_feat = batch["node_feat"].shape[1]
    cpu = gsch.init_schnet(cfg, torch.Generator().manual_seed(seed), d_feat,
                           device="cpu")
    dev = ttree.tree_map(lambda t: t.to("cuda"), cpu)
    dbatch = {k: v.to("cuda") for k, v in batch.items()}
    out = {}
    fwd = (rsteps.make_gnn_forward(cfg, device="cuda")(dev, dbatch),
           rsteps.make_gnn_forward(cfg, device="cpu")(cpu, batch))
    for what, g, c in zip(("nodes", "readout"), *fwd):
        d = float((g.cpu() - c).abs().max())
        if not torch.allclose(g.cpu(), c, rtol=GNN_TOL, atol=GNN_TOL):
            raise AssertionError(f"schnet {name} {what}: card vs CPU max |d|"
                                 f" {d:.3g}")
        out[f"{what}_max_d"] = d
    opt = toptim.AdamW(eps=GNN_EPS)
    step = rsteps.make_gnn_train_step(cfg, opt)
    pg, sg, mg = step(dev, opt.init(dev), dbatch)
    pc, sc, mc = step(cpu, opt.init(cpu), batch)
    torch.cuda.synchronize()
    lg, lc = float(mg["loss"]), float(mc["loss"])
    if not (np.isfinite(lg) and abs(lg - lc) <= GNN_TOL * abs(lc) + GNN_TOL):
        raise AssertionError(f"schnet {name} loss: card {lg!r}, CPU {lc!r}")
    out.update(loss=(lg, lc),
               params_max_d=_allclose_tree(f"schnet {name} params", pg, pc,
                                           False, GNN_TOL),
               mu_max_d=_allclose_tree(f"schnet {name} mu", sg.mu, sc.mu,
                                       True, GNN_MOMENT_TOL),
               nu_max_d=_allclose_tree(f"schnet {name} nu", sg.nu, sc.nu,
                                       True, GNN_MOMENT_TOL))
    return out


def gnn_train(name: str, cfg, shape: str, batch: dict, n_graphs: int,
              seed: int, n_real_edges: int) -> dict:
    """``GNN_STEPS`` AdamW steps of ``make_gnn_train_step`` at ``cfg`` on
    ``batch`` (tensors on the card), each timed, the last traced; the
    loss finite and the readout of the batch's graphs; then (d) one step
    repeated from the same state gives equal bits."""
    entry = registry.get("schnet")
    params = rsteps.init_params_for(entry, cfg, seed=seed,
                                    shape_spec=registry.get_shape("schnet",
                                                                  shape),
                                    device="cuda")
    opt = toptim.AdamW()
    state = opt.init(params)
    step = rsteps.make_gnn_train_step(cfg, opt, n_graphs=n_graphs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(GNN_STEPS):
        if i == GNN_STEPS - 1:
            prof = device_profile(lambda: step(params, state, batch))
            (params, state, m), dt = prof.pop("out"), prof["wall_ms"] / 1e3
        else:
            (params, state, m), dt = _timed(lambda: step(params, state,
                                                         batch))
        times.append(dt)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    _, energy = rsteps.make_gnn_forward(cfg, n_graphs, "cuda")(params,
                                                               batch)
    if not all(np.isfinite(losses)) or energy.shape != (n_graphs, 1) or \
            not bool(torch.isfinite(energy).all()):
        raise AssertionError(f"schnet {name}: losses {losses}, readout "
                             f"{tuple(energy.shape)}")
    a, b = step(params, state, batch), step(params, state, batch)
    if not _bit_equal(a, b):
        raise AssertionError(f"schnet {name}: a step repeated from the same "
                             f"state differs")
    del a, b
    step_s = float(np.median(times[1:-1]))
    if name == "minibatch_lg":
        record_step("schnet minibatch_lg", "schnet", name, {}, step_s, peak,
                    11)
    E, N = batch["src"].shape[0], batch["graph_id"].shape[0]
    out = dict(nodes=N, edges=E, real_edges=n_real_edges, step_s=times,
               median_s=step_s, edges_per_s=E / step_s,
               real_edges_per_s=n_real_edges / step_s, peak_bytes=peak,
               idle=prof["idle"], traced_ms=prof["wall_ms"],
               busy_ms=prof["busy_ms"], events=prof["events"],
               top=top_ops(prof, 3), losses=losses, repeat_bit_equal=True)
    log(f"schnet {name} training ({cfg.n_interactions} interactions, "
        f"d_hidden {cfg.d_hidden}, n_rbf {cfg.n_rbf}, {cfg.param_dtype}; "
        f"N {N}, E {E} ({n_real_edges} real), {n_graphs} graphs): steps "
        f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms (the last traced),"
        f" median {step_s * 1e3:.2f} ms, {E / step_s:.4g} edges/s "
        f"({n_real_edges / step_s:.4g} real); peak {peak / 2**30:.2f} GiB; "
        f"traced step {prof['wall_ms']:.2f} ms wall, {prof['busy_ms']:.2f} ms"
        f" device, idle {prof['idle']:.3f}, {prof['events']} device events; "
        f"top ops {out['top']}; loss {', '.join(f'{x:.5g}' for x in losses)}"
        f"; a step repeated from the same state bit-equal")
    del params, state
    return out


def gnn_atomic_steps(cfg, batch: dict, seed: int) -> list:
    """minibatch_lg's step outside deterministic mode (the scatters'
    atomic CUDA path, not bit-reproducible): what determinism costs."""
    params = rsteps.init_params_for(
        registry.get("schnet"), cfg, seed=seed,
        shape_spec=registry.get_shape("schnet", "minibatch_lg"),
        device="cuda")
    opt = toptim.AdamW()
    state = opt.init(params)
    step = rsteps.make_gnn_train_step(cfg, opt)
    times = []
    for _ in range(GNN_STEPS):
        (params, state, m), dt = _timed(lambda: step(params, state, batch))
        times.append(dt)
    if not np.isfinite(float(m["loss"])):
        raise AssertionError(f"schnet minibatch_lg (atomic): loss {m}")
    log(f"schnet minibatch_lg outside deterministic mode: steps "
        f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms")
    return times


def reddit_minibatch(seed: int):
    """(b) A Reddit-scale graph (``REDDIT_NODES`` x ``REDDIT_DEGREE``
    uniform edges from ``seed``) built on the card's sort route, its sort
    first held bit-equal to numpy's on a 1.2M-edge graph; 1,024 seeds
    sampled with fanout (15, 10), padded to minibatch_lg's (180,224,
    179,200); each node's 602 features read from a feature table on the
    card, the pad rows zero; edge distances uniform in [0, 10)."""
    spec = registry.get_shape("schnet", "minibatch_lg")
    pn, pe = registry._gnn_sample_sizes(spec)
    small = (gsamp.random_graph(24_000, 50, seed=seed, device="cuda"),
             gsamp.random_graph(24_000, 50, seed=seed))
    if not (np.array_equal(small[0].indptr, small[1].indptr) and
            np.array_equal(small[0].indices, small[1].indices)):
        raise AssertionError("graph sampler: the card's CSR differs from "
                             "numpy's")
    del small
    t0 = time.perf_counter()
    g = gsamp.random_graph(REDDIT_NODES, REDDIT_DEGREE, seed=seed,
                           device="cuda")
    build_s = time.perf_counter() - t0
    n_edges = REDDIT_NODES * REDDIT_DEGREE
    if g.indptr[-1] != n_edges or g.indices.shape != (n_edges,) or \
            bool((np.diff(g.indptr) < 0).any()):
        raise AssertionError("graph sampler: a malformed CSR")
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    seeds = rng.choice(REDDIT_NODES, spec.extra("batch_nodes"),
                       replace=False)
    sub = gsamp.sample_subgraph(g, seeds, spec.extra("fanout"), rng,
                                pad_nodes=pn, pad_edges=pe)
    sample_s = time.perf_counter() - t0
    del g
    n, e = sub["n_nodes"], sub["n_edges"]
    ids = sub["node_ids"]
    if len(ids) != pn or len(sub["src"]) != pe or \
            len(np.unique(ids[:n])) != n or (sub["dst"][:e] >= n).any():
        raise AssertionError(f"graph sampler: a malformed subgraph ({n} "
                             f"nodes, {e} edges)")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d_feat = spec.extra("d_feat")
    table = torch.randn(REDDIT_NODES, d_feat, generator=gen, device="cuda")
    idx = torch.as_tensor(ids, device="cuda")
    feat = table.index_select(0, idx.clamp(min=0))
    feat[n:] = 0
    del table
    batch = dict(node_feat=feat,
                 src=torch.as_tensor(sub["src"], device="cuda"),
                 dst=torch.as_tensor(sub["dst"], device="cuda"),
                 edge_dist=10 * torch.rand(pe, generator=gen, device="cuda"),
                 graph_id=torch.zeros(pn, dtype=torch.int32, device="cuda"),
                 targets=torch.randn(1, generator=gen, device="cuda"))
    log(f"graph sampler: Reddit-scale graph ({REDDIT_NODES} nodes, "
        f"{n_edges} edges) built in {build_s:.2f} s with the card's sort "
        f"(equal to numpy's at 24,000 x 50); {len(seeds)} seeds, fanout "
        f"{spec.extra('fanout')}: {n} nodes, {e} edges (pads {pn}, {pe}) in "
        f"{sample_s:.2f} s")
    return batch, dict(build_s=build_s, sample_s=sample_s, nodes=n,
                       edges=e, graph_edges=n_edges)


def molecule_batch(seed: int):
    """(c) molecule's 128 molecules of 30 atoms and 64 edges each, atom
    types from QM9's elements, edges inside each molecule with distances
    uniform in [0.8, 5) (bond to non-bonded range, within the cutoff), a
    target a molecule, on the card."""
    spec = registry.get_shape("schnet", "molecule")
    B, n, e = spec.extra("batch"), spec.extra("n_nodes"), spec.extra(
        "n_edges")
    rng = np.random.default_rng(seed)
    base = np.repeat(np.arange(B) * n, e)
    batch = dict(
        atom_type=rng.choice(MOLECULE_ATOMS, B * n),
        src=rng.integers(0, n, B * e) + base,
        dst=rng.integers(0, n, B * e) + base,
        edge_dist=rng.uniform(0.8, 5.0, B * e),
        graph_id=np.repeat(np.arange(B), n),
        targets=rng.normal(size=B))
    return {k: torch.as_tensor(v, dtype=torch.float32 if v.dtype.kind == "f"
                               else torch.int32, device="cuda")
            for k, v in batch.items()}, B


def phase_gnn(seed: int) -> dict:
    """Phase 11 (runs in deterministic mode with TF32 off)."""
    _lm_free()
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    torch.backends.cudnn.allow_tf32 = False
    full = registry.get("schnet").config
    res = {}
    with deterministic():
        t0 = time.perf_counter()
        rng = np.random.default_rng(seed)
        spec = registry.get_shape("schnet", "full_graph_sm")
        sm = gnn_graph(rng, spec.extra("n_nodes"), spec.extra("n_edges"),
                       spec.extra("d_feat"))
        res["card_vs_cpu"] = {
            "reduced": gnn_card_vs_cpu("reduced (50 nodes, 200 edges)",
                                       registry.reduced_config("schnet"),
                                       gnn_graph(rng, 50, 200, 16), seed),
            "full_graph_sm": gnn_card_vs_cpu("full_graph_sm", full, sm,
                                             seed)}
        log("schnet card vs CPU (one AdamW step, TF32 off): " +
            json.dumps(res["card_vs_cpu"]))
        res["card_vs_cpu_s"] = time.perf_counter() - t0
        sm = {k: v.to("cuda") for k, v in sm.items()}
        res["full_graph_sm"] = gnn_train("full_graph_sm", full,
                                         "full_graph_sm", sm, 1, seed,
                                         spec.extra("n_edges"))
        del sm
        batch, res["sampler"] = reddit_minibatch(seed)
        res["minibatch_lg"] = gnn_train("minibatch_lg", full, "minibatch_lg",
                                        batch, 1, seed,
                                        res["sampler"]["edges"])
        mol, B = molecule_batch(seed)
        res["molecule"] = gnn_train("molecule", full, "molecule", mol, B,
                                    seed, mol["src"].shape[0])
        del mol
    res["minibatch_lg"]["atomic_step_s"] = gnn_atomic_steps(full, batch,
                                                            seed)
    del batch
    _lm_free()
    return res


# ---------------------------------------------------------------------------
# Phase 12: the mesh, the sharding rules, the dry-run and the roofline
# ---------------------------------------------------------------------------
PHASE_STEPS = {}      # name -> one timed step of phases 6, 9, 10, 11


def record_step(name: str, arch: str, shape: str, over: dict, sec: float,
                peak: int, phase: int) -> None:
    """A phase's median step time and peak device memory, for (c)."""
    PHASE_STEPS[name] = dict(arch=arch, shape=shape, over=over, sec=sec,
                             peak_bytes=int(peak), phase=phase)


# (c)'s steps at the shapes their phases run (the dry-run's overrides);
# the LMs probed at two depths and extrapolated (exact in FLOPs and bytes)
ROOF_STEPS = [
    ("tinyllama-1.1b train_4k", "tinyllama-1.1b", "train_4k",
     dict(global_batch=8, seq_len=4096, n_microbatches=2, q_chunk=512,
          probe=True)),
    ("gemma3-12b prefill_32k", "gemma3-12b", "prefill_32k",
     dict(global_batch=1, seq_len=32768, q_chunk=256, probe=True)),
    ("qwen2-moe-a2.7b prefill_32k", "qwen2-moe-a2.7b", "prefill_32k",
     dict(global_batch=1, seq_len=32768, q_chunk=256, probe=True)),
    ("dcn-v2 serve_bulk", "dcn-v2", "serve_bulk", {}),
    ("dcn-v2 train_batch", "dcn-v2", "train_batch", {}),
    ("schnet minibatch_lg", "schnet", "minibatch_lg", {}),
]
# (b): two cells at full width on the (16, 16) mesh of fake ranks
MESH_CELLS = [("tinyllama-1.1b", "train_4k"), ("dcn-v2", "serve_p99")]
TRACE_TIMEOUT = 600


def _dryrun_cmd(arch, shape, mesh, over, out):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--mesh", mesh, "--out", out]
    if over:
        cmd += ["--set"] + [f"{k}={v}" for k, v in over.items()]
    return cmd


class LaunchTraces:
    """Phase 12's dry-runs, each its own subprocess (the fake world lives
    in no other process), started when the script starts and run at the
    lowest priority on one thread each while the other phases use the
    card: (b)'s two cells on the fake (16, 16) mesh and (c)'s six steps on
    the card's own one-device NCCL mesh (``--mesh card``)."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="dryrun_")
        env = dict(os.environ, PYTHONPATH=_SRC, OMP_NUM_THREADS="1")
        self.procs = {}
        jobs = [(f"mesh {a} {s}", a, s, "single", {}) for a, s in MESH_CELLS]
        jobs += [(f"card {n}", a, s, "card", o) for n, a, s, o in ROOF_STEPS]
        self.t0 = time.perf_counter()
        for key, arch, shape, mesh, over in jobs:
            out = os.path.join(self.dir, key.replace(" ", "_") + ".jsonl")
            proc = subprocess.Popen(
                _dryrun_cmd(arch, shape, mesh, over, out), env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True, preexec_fn=lambda: os.nice(19))
            self.procs[key] = (proc, out)

    def result(self, key: str) -> dict:
        """The job's JSON record and its wall time (waits for it)."""
        proc, out = self.procs[key]
        try:
            _, err = proc.communicate(timeout=TRACE_TIMEOUT)
        except subprocess.TimeoutExpired:
            self.kill()
            raise AssertionError(f"dry-run {key}: over {TRACE_TIMEOUT} s")
        rec = {}
        if os.path.exists(out):
            with open(out) as f:
                rec = json.loads(f.read().strip().splitlines()[-1])
        if proc.returncode != 0 or not rec.get("ok"):
            raise AssertionError(f"dry-run {key}: exit {proc.returncode}: "
                                 f"{rec.get('error')} {(err or '')[-2000:]}")
        return rec

    def kill(self) -> None:
        """Stop every job still running."""
        for proc, _ in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _first_difference(run_plain, run_mesh) -> str:
    """The first op whose output differs between the plain forward and
    the one over the one-device mesh (each op's output, in order)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.outs = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor):
                t = (out.to_local() if isinstance(out, DTensor)
                     else out).detach()
                sums = (float(t.double().sum()), float(t.double().abs().sum())
                        ) if t.is_floating_point() else (
                    float(t.long().sum()),)
                self.outs.append((str(func), tuple(t.shape), sums))
            return out

    recs = []
    for run in (run_plain, run_mesh):
        with Record() as r:
            run()
        recs.append(r.outs)
    for i, ((f, sa, a), (g, sb, b)) in enumerate(zip(*recs)):
        if sa != sb or a != b:
            return f"op {i}: {f} (mesh run: {g})"
    return f"no op output differs ({len(recs[0])} vs {len(recs[1])} ops)"


def launch_forward(seed: int) -> dict:
    """(a) TinyLlama-1.1B's forward at full width (bf16, 1 x 4,096 tokens,
    phase 10's tree from ``seed``): plainly, and with its parameters as
    DTensors on the card's one-device NCCL mesh under the cell's rules;
    the logits bit-equal, or the first op that differs is reported."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.dist.sharding import (Resharding, distribute_tree,
                                           tree_shardings, use_rules)
    from repro_torch.launch import dryrun as tdry
    arch = "tinyllama-1.1b"
    cfg = registry.get(arch).config
    spec = dataclasses.replace(registry.get_shape(arch, "train_4k"),
                               global_batch=1, seq_len=TRAIN_LEN)
    _lm_free()
    params = lm.init_lm(cfg, seed=seed, device="cuda")
    toks = tlm_data.make_batch_fn(tlm_data.LMDataConfig(
        vocab=cfg.vocab, batch=1, seq_len=TRAIN_LEN, seed=seed),
        device="cuda")(0)
    with torch.no_grad():
        plain, t_plain = _timed(lambda: lm.lm_forward(params, toks, cfg,
                                                      512))
        with tdry.mesh_for("card") as mesh:
            rules = tdry.rules_for(mesh, registry.get(arch), spec, {})
            dparams = distribute_tree(params, mesh, tree_shardings(
                rules, lm.lm_param_specs(cfg)))

            def run_mesh():
                with use_rules(rules), implicit_replication(), Resharding():
                    out = lm.lm_forward(dparams, toks, cfg, 512)
                return out.full_tensor() if isinstance(out, DTensor) \
                    else out
            got, t_mesh = _timed(run_mesh)
            kinds = sorted({type(t).__name__
                            for t in ttree.leaves(dparams)})
            equal = torch.equal(got, plain)
            where = "" if equal else _first_difference(
                lambda: lm.lm_forward(params, toks, cfg, 512), run_mesh)
            backend = dist.get_backend()
        del dparams
    if not torch.isfinite(plain).all():
        raise AssertionError("(a) plain logits not finite")
    d = float((got.float() - plain.float()).abs().max())
    out = dict(shape=list(plain.shape), dtype=str(plain.dtype),
               bit_equal=equal, max_abs_diff=d, plain_s=t_plain,
               mesh_s=t_mesh, param_types=kinds, backend=backend)
    log(f"phase 12 (a) tinyllama-1.1b forward 1 x {TRAIN_LEN} bf16: plain "
        f"{t_plain:.3f} s, on the one-device {backend} mesh ({kinds} "
        f"parameters, {plain.shape[-1]}-wide logits) {t_mesh:.3f} s; "
        f"bit-equal {equal} (max |d| {d:.3g})")
    del params, plain, got
    _lm_free()
    if not equal:
        raise AssertionError(f"(a) logits differ on the one-device mesh: "
                             f"first at {where}")
    return out


def phase_launch(traces: LaunchTraces, seed: int, timed: bool) -> dict:
    """Phase 12: (a) the one-device mesh forward; (b) the dry-run of two
    cells at full width on the fake (16, 16) mesh; (c) each timed step's
    roofline on the card's mesh with its dtype's peak, beside its phase's
    median and peak memory (``timed``: the phases ran)."""
    from repro_torch.launch import roofline as RL
    out = {"a": launch_forward(seed), "b": {}, "c": {}}
    for arch, shape in MESH_CELLS:
        rec = traces.result(f"mesh {arch} {shape}")
        out["b"][f"{arch} {shape}"] = rec
        log(f"phase 12 (b) dry-run {arch} {shape} on the fake (16, 16) "
            f"mesh ({rec['n_devices']} ranks), traced in {rec['t_lower_s']}"
            f" s: " + json.dumps({k: rec[k] for k in (
                "flops_per_dev", "bytes_per_dev", "wire_bytes_per_dev",
                "per_device_mem", "bottleneck", "roofline_fraction",
                "useful_flop_ratio", "collectives")}))
    if not timed:
        log("phase 12 (c): no phase times under --launch-only; bounds "
            "only")
    for name, arch, shape, _ in ROOF_STEPS:
        rec = traces.result(f"card {name}")
        if rec["n_devices"] != 1 or rec["mesh"] != "card":
            raise AssertionError(f"(c) {name}: not on the card's mesh")
        r = RL.Roofline(
            arch=arch, shape=shape, mesh="card", flops=rec["flops_per_dev"],
            hlo_bytes=rec["bytes_per_dev"],
            wire_bytes=rec["wire_bytes_per_dev"],
            model_flops=rec["model_flops"], n_devices=1,
            per_device_mem=rec["per_device_mem"], collective_detail={},
            peak=rec["peak"])
        row = dict(bound_s=r.t_bound, bound_by=r.bottleneck,
                   t_compute=r.t_compute, t_memory=r.t_memory,
                   model_flops=r.model_flops, peak=r.peak,
                   per_device_mem=r.per_device_mem,
                   traced_s=rec["t_lower_s"])
        if not all(np.isfinite(v) and v > 0 for v in (
                r.t_bound, r.model_flops, r.per_device_mem)):
            raise AssertionError(f"(c) {name}: {row}")
        step = PHASE_STEPS.get(name) if timed else None
        if timed and step is None:
            raise AssertionError(f"(c) {name}: its phase recorded no time")
        msg = (f"phase 12 (c) {name}: bound {r.t_bound:.4g} s by "
               f"{r.bottleneck} (compute {r.t_compute:.4g} s at "
               f"{r.peak} {r.peak_flops / 1e12:.0f} TFLOP/s, memory "
               f"{r.t_memory:.4g} s); model FLOPs {r.model_flops:.4g}; "
               f"dry-run memory {r.per_device_mem / 2**30:.2f} GiB")
        if step is not None:
            row.update(measured_s=step["sec"], mfu=r.mfu(step["sec"]),
                       bound_share=r.t_bound / step["sec"],
                       max_memory_allocated=step["peak_bytes"],
                       phase=step["phase"])
            msg += (f"; phase {step['phase']} median {step['sec']:.4g} s: "
                    f"mfu {row['mfu']:.4f}, bound/time "
                    f"{row['bound_share']:.4f}; max_memory_allocated "
                    f"{step['peak_bytes'] / 2**30:.2f} GiB")
        out["c"][name] = row
        log(msg)
    traces.kill()
    return out


def sweep(path: str) -> dict:
    """Every cell of the grid on both fake meshes (``dryrun --all``, the
    LMs probed at two depths, eight cells at a time); its wall time and
    one line a cell."""
    env = dict(os.environ, PYTHONPATH=_SRC, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    rc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                         "--all", "--meshes", "single,multi", "--jobs", "8",
                         "--set", "probe=True", "--out", path],
                        env=env, stdout=subprocess.DEVNULL).returncode
    wall = time.perf_counter() - t0
    with open(path) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    for r in recs:
        log("sweep " + (json.dumps({k: r.get(k) for k in (
            "arch", "shape", "mesh", "flops_per_dev", "bytes_per_dev",
            "wire_bytes_per_dev", "per_device_mem", "bottleneck",
            "roofline_fraction", "t_lower_s")}) if r.get("ok") else
            json.dumps(r)))
    ok = sum(1 for r in recs if r.get("ok"))
    log(f"sweep: {ok} of {len(recs)} cells ok in {wall:.1f} s (exit {rc})")
    if rc != 0 or ok != 72:
        raise AssertionError(f"sweep: {ok} of {len(recs)} ok, exit {rc}")
    return dict(cells=len(recs), ok=ok, wall_s=wall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--segment-log2", type=int, default=23,
                    help="docs per segment = 2**N (the vocabulary scales "
                         "with it: 2**(N-3) terms)")
    ap.add_argument("--paged-only", action="store_true",
                    help="run only the build and the paged-serving phase")
    ap.add_argument("--recsys-only", action="store_true",
                    help="run only the build and the recsys-serving phase")
    ap.add_argument("--serve-only", action="store_true",
                    help="run only the build, the main path (phase 3) and "
                         "search serving (phase 7)")
    ap.add_argument("--lm-only", action="store_true",
                    help="run only the build and the LMs at full width "
                         "(phase 9)")
    ap.add_argument("--train-only", action="store_true",
                    help="run only the build and training (phase 10)")
    ap.add_argument("--gnn-only", action="store_true",
                    help="run only the build and SchNet (phase 11)")
    ap.add_argument("--sharded-only", action="store_true",
                    help="run only the build and the sharded index (phase "
                         "8, with its own brute force)")
    ap.add_argument("--ranks-only", action="store_true",
                    help="run only the build and the index on ranks "
                         "(phase 8c, with its own brute force)")
    ap.add_argument("--recsys-ranks-only", action="store_true",
                    help="run only the build and the recsys steps on ranks "
                         "(phase 6r, with its own DLRM reference)")
    ap.add_argument("--rank-child", default="", help=argparse.SUPPRESS)
    ap.add_argument("--intersect-calls", default="", metavar="PATH",
                    help="run only the build and phase 4, and save the "
                         "sequential route's intersect_mask inputs to PATH "
                         "(for launch/time_intersect_mask.py --calls)")
    ap.add_argument("--segment-calls", default="", metavar="PATH",
                    help="run only the build, phase 3 and phase 4, and save "
                         "the frozen-segment kernels' inputs to PATH (for "
                         "launch/time_segment_intersect.py --calls)")
    ap.add_argument("--bag-calls", default="", metavar="PATH",
                    help="run only the build and phase 6's captures, and "
                         "save its ten embedding_bag calls to PATH (for "
                         "launch/time_embedding_bag.py --calls)")
    ap.add_argument("--launch-only", action="store_true",
                    help="run only the build, phase 12 (no phase times) "
                         "and the dry-run sweep of every cell on both "
                         "fake meshes")
    ap.add_argument("--sweep-out", default="", metavar="PATH",
                    help="where --launch-only's sweep writes its JSON lines "
                         "(default: a temporary file)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.rank_child:
        return rank_child(json.loads(args.rank_child))
    t_start = time.perf_counter()
    card = nvidia_smi()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    build_s = _cuda.build_seconds()
    log(f"kernels built and loaded in {build_s:.1f} s")

    table = []
    saving = args.intersect_calls or args.bag_calls or args.segment_calls
    launch = not (saving or args.paged_only or args.recsys_only or
                  args.serve_only or args.sharded_only or args.lm_only or
                  args.train_only or args.gnn_only or args.ranks_only or
                  args.recsys_ranks_only)
    traces = LaunchTraces() if launch else None
    try:
        table = run_phases(args, saving, table)
        if launch:
            t0 = time.perf_counter()
            res = phase_launch(traces, seed=0, timed=not args.launch_only)
            log(f"launch phase {time.perf_counter() - t0:.1f} s (its "
                f"dry-runs started {time.perf_counter() - traces.t0:.1f} s "
                f"ago, beside the other phases)")
            if args.launch_only:
                path = args.sweep_out or os.path.join(traces.dir,
                                                      "sweep.jsonl")
                res["sweep"] = sweep(path)
    finally:
        if traces is not None:
            traces.kill()
    log(f"wall {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": table}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_phases(args, saving, table) -> list:
    """Phases 2-11 as the flags select them; the kernel table's rows."""
    if args.intersect_calls:
        phase_small(args.intersect_calls)
    elif args.segment_calls:
        save_segment_calls(args.segment_calls, args.segment_log2)
    elif args.bag_calls:
        save_bag_calls(args.bag_calls, seed=0)
    elif args.sharded_only:
        docs, _, vocab, seg_docs, extra, _ = index_stream(args.segment_log2)
        phases_sharded(docs, vocab, seg_docs, extra, q_rows=8)
        del docs
    elif args.ranks_only:
        docs, _, vocab, seg_docs, extra, _ = index_stream(args.segment_log2)
        oracle = rank_oracle(docs, vocab, seg_docs + extra)
        t0 = time.perf_counter()
        res = phase_ranks(docs, vocab, seg_docs, extra, oracle)
        log(f"phase 8c (ranks) {time.perf_counter() - t0:.1f} s")
        log("ranks: " + json.dumps(res))
        del docs
    elif not (args.paged_only or args.recsys_only or args.lm_only or
              args.train_only or args.gnn_only or args.launch_only or
              args.ranks_only or args.recsys_ranks_only):
        table = phase_index(args.segment_log2, serve_only=args.serve_only)
    only = (args.serve_only or args.sharded_only or args.lm_only or
            args.train_only or args.gnn_only or args.launch_only or
            args.ranks_only or args.recsys_ranks_only)
    if not (args.recsys_only or only or saving):
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
    if not (args.paged_only or only or saving):
        t0 = time.perf_counter()
        table.append(phase_recsys(seed=0))
        log(f"recsys phase {time.perf_counter() - t0:.1f} s")
    ranked = None
    if not (args.paged_only or args.recsys_only or saving or
            (only and not args.recsys_ranks_only)):
        t0 = time.perf_counter()
        ranked = phase_recsys_ranks(seed=0)
        log(f"phase 6r (recsys on ranks) {time.perf_counter() - t0:.1f} s")
        log("recsys ranks: " + json.dumps(ranked))
        ranked_rows(table, ranked)
    if not (args.paged_only or args.recsys_only or args.serve_only or
            args.sharded_only or args.train_only or args.gnn_only or saving
            or args.launch_only or args.ranks_only or
            args.recsys_ranks_only):
        t0 = time.perf_counter()
        lms = phase_lm(seed=0)
        log("lm phase: " + json.dumps(lms))
        log(f"lm phase {time.perf_counter() - t0:.1f} s")
    if not (args.paged_only or args.recsys_only or args.serve_only or
            args.sharded_only or args.lm_only or args.gnn_only or saving
            or args.launch_only or args.ranks_only or
            args.recsys_ranks_only):
        t0 = time.perf_counter()
        row, trained = phase_train(seed=0)
        table.append(row)
        if ranked is not None:
            ranked_rows(table, ranked)
        log("train phase: " + json.dumps(trained))
        log(f"train phase {time.perf_counter() - t0:.1f} s")
    if not (args.paged_only or args.recsys_only or args.serve_only or
            args.sharded_only or args.lm_only or args.train_only or saving
            or args.launch_only or args.ranks_only or
            args.recsys_ranks_only):
        t0 = time.perf_counter()
        log("gnn phase: " + json.dumps(phase_gnn(seed=0)))
        log(f"gnn phase {time.perf_counter() - t0:.1f} s")
    return table


if __name__ == "__main__":
    sys.exit(main())
