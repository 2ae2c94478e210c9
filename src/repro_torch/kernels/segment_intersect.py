"""Fused gap-decode + sorted-set intersection over frozen CSR segments.

Frozen read-only segments store each term's docids gap-compressed in
128-docid blocks (a byte-aligned PForDelta-lite: per-block byte width
1/2/4, little-endian gap planes — :func:`pack_docids`).  The host half
of this module packs, stacks and re-pads those lists (numpy, byte for
byte the reference package's layout); the device half decodes them
(:func:`decode_stacked`, plain torch) and intersects them in the CUDA
kernel ``csrc/segment_intersect.cu`` (:func:`segment_intersect_mask`,
:func:`segment_intersect_mask_batched`).  Scored lists carry one uint8
impact per docid lane and a per-block maximum (:class:`ScoredList`,
:class:`ScoredStack`); their scored conjunction with the block-max skip
is the CUDA kernel ``csrc/scored_intersect.cu``
(:func:`scored_intersect_batched`).

Host-side leaves keep the reference's numpy dtypes (uint32 docids and
payload words); :meth:`StackedLists.to` / :meth:`PackedList.to` move them
to torch, where every uint32 travels as an int64 holding the value.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _cuda

INVALID = 0xFFFFFFFF
SEG_BLOCK = 128          # docids per compressed block
SLAB_WORDS = SEG_BLOCK   # words one block may span (bw=4 worst case)
SCORE_MAX = 255          # 8-bit quantized impact ceiling (min(tf, 255))
SCORE_WORDS = SEG_BLOCK // 4   # uint32 words per block's score plane

_U32_FIELDS = ("firsts", "payload")


def _to_torch(x, device, u32: bool):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.asarray(x)
    return torch.from_numpy(
        np.ascontiguousarray(x.astype(np.int64 if u32 else np.int32))
    ).to(device)


class PackedList(NamedTuple):
    """One term's docid list, block-gap-compressed.

    ``woffs[b]`` is the start word of block b's gap plane inside
    ``payload``; the plane holds 32 * bw words (bw = bytes per gap), and
    ``payload`` carries SLAB_WORDS trailing zero words.  Lane 0's gap is
    stored as 0, so a block decodes as ``firsts[b] + cumsum(gaps)``.  The
    last block is padded by repeating the final docid (gap 0).
    """
    firsts: object      # uint32[n_blocks]  docid of lane 0
    bws: object         # int32[n_blocks]   bytes per gap: 1, 2 or 4
    woffs: object       # int32[n_blocks]   payload word offset
    payload: object     # uint32[total_words + SLAB_WORDS]
    n: int              # valid docids

    @property
    def n_blocks(self) -> int:
        return self.firsts.shape[0]

    def to(self, device) -> "PackedList":
        """Torch leaves on ``device`` (uint32 leaves as int64)."""
        return PackedList(
            *[_to_torch(getattr(self, f), device, f in _U32_FIELDS)
              for f in ("firsts", "bws", "woffs", "payload")], n=self.n)


def _pow2(x: int) -> int:
    return 1 << max(int(x - 1).bit_length(), 0)


def pack_docids(ids: np.ndarray) -> PackedList:
    """Gap-compress an ascending deduped uint32 docid array (host-side,
    at segment freeze or first query — off the device path).

    Block count and payload length are padded to the next power of two;
    pad blocks decode to the INVALID sentinel (0xFFFFFFFF first, zero
    gaps).  Vectorised over blocks: the payload is byte-identical to the
    reference's block-by-block loop.
    """
    ids = np.asarray(ids, np.uint32)
    n = int(ids.size)
    if n == 0:
        return PackedList(
            firsts=np.zeros((0,), np.uint32), bws=np.zeros((0,), np.int32),
            woffs=np.zeros((0,), np.int32),
            payload=np.zeros((SLAB_WORDS,), np.uint32), n=0)
    nb = -(-n // SEG_BLOCK)
    nb_pad = _pow2(nb)
    chunk = np.empty(nb * SEG_BLOCK, np.int64)
    chunk[:n] = ids
    chunk[n:] = ids[-1]                     # last block repeats the tail
    chunk = chunk.reshape(nb, SEG_BLOCK)
    gaps = np.zeros_like(chunk)
    gaps[:, 1:] = np.diff(chunk, axis=1)    # lane 0 -> 0
    g_max = gaps.max(axis=1)
    bw = np.where(g_max < (1 << 8), 1, np.where(g_max < (1 << 16), 2, 4))
    words = 32 * bw
    woff = np.zeros(nb, np.int64)
    woff[1:] = np.cumsum(words)[:-1]
    total = int(words.sum())
    payload = np.zeros(_pow2(total + SLAB_WORDS), np.uint32)
    for width, dt in ((1, "<u1"), (2, "<u2"), (4, "<u4")):
        rows = np.nonzero(bw == width)[0]
        if rows.size:
            planes = np.ascontiguousarray(gaps[rows].astype(dt)).view("<u4")
            dest = woff[rows][:, None] + np.arange(32 * width)
            payload[dest] = planes
    firsts = np.full(nb_pad, INVALID, np.uint32)
    firsts[:nb] = chunk[:, 0]
    bws = np.ones(nb_pad, np.int32)
    bws[:nb] = bw
    woffs = np.full(nb_pad, total, np.int32)   # pad blocks: zero tail
    woffs[:nb] = woff
    return PackedList(firsts=firsts, bws=bws, woffs=woffs, payload=payload,
                      n=n)


class StackedLists(NamedTuple):
    """A batch of :class:`PackedList`s padded to SHARED pow2 shapes and
    stacked on leading axes (``[G, ...]`` per-term stacks, gathered
    ``[Q, T, G, ...]`` batches, the kernel's ``[N, ...]`` rows).  Pad
    blocks decode to INVALID (firsts = INVALID, zero gap plane)."""
    firsts: object      # uint32[..., NB]
    bws: object         # int32[..., NB]
    woffs: object       # int32[..., NB]
    payload: object     # uint32[..., PW]
    ns: object          # int32[...] valid docids per list

    @property
    def n_blocks(self) -> int:
        return self.firsts.shape[-1]

    @property
    def n_words(self) -> int:
        return self.payload.shape[-1]

    def to(self, device) -> "StackedLists":
        """Torch leaves on ``device`` (uint32 leaves as int64)."""
        return StackedLists(
            *[_to_torch(getattr(self, f), device, f in _U32_FIELDS)
              for f in StackedLists._fields])


def stack_packed(packs, n_blocks: int = None,
                 n_words: int = None) -> StackedLists:
    """Stack PackedLists into one numpy :class:`StackedLists`.

    ``n_blocks``/``n_words`` override the shared padded shape (>= every
    input's); by default the next power of two over the batch.  Every
    pad block's ``woff`` points at its own row's zero tail.
    """
    G = len(packs)
    nb = max([p.n_blocks for p in packs] + [1])
    pw = max([p.payload.shape[0] for p in packs] + [SLAB_WORDS])
    nb = _pow2(nb) if n_blocks is None else n_blocks
    pw = _pow2(pw) if n_words is None else n_words
    firsts = np.full((G, nb), INVALID, np.uint32)
    bws = np.ones((G, nb), np.int32)
    woffs = np.zeros((G, nb), np.int32)
    payload = np.zeros((G, pw), np.uint32)
    ns = np.zeros((G,), np.int32)
    for g, p in enumerate(packs):
        k = p.n_blocks
        pay = np.asarray(p.payload)
        payload[g, : pay.shape[0]] = pay
        woffs[g, :] = pay.shape[0] - SLAB_WORDS
        if k:
            firsts[g, :k] = np.asarray(p.firsts)
            bws[g, :k] = np.asarray(p.bws)
            woffs[g, :k] = np.asarray(p.woffs)
        ns[g] = p.n
    return StackedLists(firsts=firsts, bws=bws, woffs=woffs,
                        payload=payload, ns=ns)


def repad_stacked(s: StackedLists, n_blocks: int,
                  n_words: int) -> StackedLists:
    """Grow a numpy stack to a wider shared bucket; new pad blocks reuse
    each row's zero-tail woff and new payload words are zeros."""
    nb0, pw0 = s.n_blocks, s.n_words
    if nb0 == n_blocks and pw0 == n_words:
        return s
    if nb0 > n_blocks or pw0 > n_words:
        raise ValueError(f"cannot shrink a stack: ({nb0}, {pw0}) -> "
                         f"({n_blocks}, {n_words})")
    lead = s.firsts.shape[:-1]
    pad_b = [(0, 0)] * len(lead) + [(0, n_blocks - nb0)]
    pad_w = [(0, 0)] * len(lead) + [(0, n_words - pw0)]
    zero_woff = s.payload.shape[-1] - SLAB_WORDS  # per-row zero tail
    woffs = np.concatenate(
        [s.woffs, np.broadcast_to(
            np.asarray(zero_woff, np.int32),
            lead + (n_blocks - nb0,)).copy()],
        axis=-1) if n_blocks > nb0 else s.woffs
    return StackedLists(
        firsts=np.pad(s.firsts, pad_b, constant_values=INVALID),
        bws=np.pad(s.bws, pad_b, constant_values=1),
        woffs=woffs,
        payload=np.pad(s.payload, pad_w),
        ns=s.ns)


def _unpack_gaps(slab, bw):
    """Decode gap lanes from ``slab`` int64[..., SLAB_WORDS] (uint32
    words) by byte width ``bw`` int32[...]: a byte, halfword or whole
    word per lane, chosen with ``where`` exactly as the reference does
    (any width other than 1 or 2 reads whole words)."""
    lead = slab.shape[:-1]
    dev = slab.device
    s8 = torch.arange(4, device=dev) * 8
    s16 = torch.arange(2, device=dev) * 16
    b1 = ((slab[..., : SEG_BLOCK // 4, None] >> s8) & 0xFF).reshape(
        lead + (SEG_BLOCK,))
    b2 = ((slab[..., : SEG_BLOCK // 2, None] >> s16) & 0xFFFF).reshape(
        lead + (SEG_BLOCK,))
    bw = bw[..., None]
    return torch.where(bw == 1, b1, torch.where(bw == 2, b2, slab))


def _decode_blocks(firsts, bws, woffs, payload):
    """[..., NB] block tables + [..., PW] payload -> [..., NB, 128]."""
    pw = payload.shape[-1]
    idx = (woffs.long()[..., None]
           + torch.arange(SLAB_WORDS, device=payload.device))
    idx = idx.clamp_(0, max(pw - 1, 0))
    lead = idx.shape[:-2]
    src = payload.reshape(lead + (1, pw)).expand(idx.shape[:-1] + (pw,))
    slabs = torch.gather(src, -1, idx)
    gaps = _unpack_gaps(slabs, bws)
    return (firsts[..., None] + torch.cumsum(gaps, dim=-1)) & 0xFFFFFFFF


def decode_stacked(s: StackedLists) -> torch.Tensor:
    """Batched all-blocks decode of a torch-leaved stack: int64[..., NB *
    SEG_BLOCK] ascending docids, INVALID past each list's ``ns``."""
    lead = s.firsts.shape[:-1]
    nb = s.n_blocks
    ids = _decode_blocks(s.firsts, s.bws, s.woffs, s.payload)
    flat = ids.reshape(lead + (nb * SEG_BLOCK,))
    lane = torch.arange(nb * SEG_BLOCK, device=flat.device)
    return torch.where(lane < s.ns[..., None], flat,
                       torch.full_like(flat, INVALID))


def decode_packed(packed: PackedList, device="cuda") -> torch.Tensor:
    """All-blocks decode of one list: int64[n_blocks * SEG_BLOCK],
    INVALID past ``n`` (the query engines' list representation).
    Numpy leaves are moved to ``device``; torch leaves decode where
    they lie."""
    if not isinstance(packed.firsts, torch.Tensor):
        packed = packed.to(device)
    if packed.n_blocks == 0:
        return torch.zeros((0,), dtype=torch.int64,
                           device=packed.firsts.device)
    ids = _decode_blocks(packed.firsts, packed.bws, packed.woffs,
                         packed.payload).reshape(-1)
    lane = torch.arange(ids.shape[0], device=ids.device)
    return torch.where(lane < packed.n, ids, torch.full_like(ids, INVALID))


# ---------------------------------------------------------------------------
# Scored lists: per-posting quantized impacts + per-block max-score planes
# ---------------------------------------------------------------------------
class ScoredList(NamedTuple):
    """A :class:`PackedList` plus its quantized impact plane (numpy).

    ``swords`` packs one uint8 impact per docid lane, four lanes per
    little-endian uint32 word, 32 words per block, in the decoded lane
    order.  Valid lanes carry impacts in [1, SCORE_MAX]; pad lanes and
    pad blocks are zero, so 0 doubles as the no-hit sentinel.
    ``bmax[b]`` is block b's max impact (the block-max WAND bound) and
    ``smax`` the list-wide max (0 for an empty list).
    """
    ids: PackedList
    swords: object      # uint32[n_blocks * SCORE_WORDS]
    bmax: object        # int32[n_blocks]
    smax: int


def attach_scores(ids: PackedList, scores: np.ndarray) -> ScoredList:
    """Attach an impact plane to a packed docid list (host-side, at
    first query).  ``scores[i]`` belongs to the i-th valid docid lane and
    must sit in [1, SCORE_MAX] — 0 is reserved for pad lanes."""
    scores = np.asarray(scores)
    if scores.shape != (ids.n,):
        raise ValueError(f"scores shape {scores.shape} != ({ids.n},)")
    if ids.n and (scores.min() < 1 or scores.max() > SCORE_MAX):
        raise ValueError("impact scores must be in [1, SCORE_MAX]")
    nb = ids.n_blocks
    lanes = np.zeros(nb * SEG_BLOCK, np.uint8)
    lanes[: ids.n] = scores
    swords = np.ascontiguousarray(lanes).view("<u4")
    bmax = (lanes.reshape(nb, SEG_BLOCK).max(axis=1).astype(np.int32)
            if nb else np.zeros(0, np.int32))
    smax = int(scores.max()) if ids.n else 0
    return ScoredList(ids=ids, swords=swords, bmax=bmax, smax=smax)


def pack_scored(ids: np.ndarray, scores: np.ndarray) -> ScoredList:
    """Gap-compress ascending deduped docids and attach their impacts."""
    return attach_scores(pack_docids(ids), scores)


class ScoredStack(NamedTuple):
    """A batch of :class:`ScoredList`s on shared pow2 shapes — the scored
    counterpart of :class:`StackedLists`.  Pad rows and blocks carry
    all-zero score planes and zero ``bmax``."""
    ids: StackedLists
    swords: object      # uint32[..., NB * SCORE_WORDS]
    bmax: object        # int32[..., NB]

    def to(self, device) -> "ScoredStack":
        """Torch leaves on ``device`` (uint32 leaves as int64)."""
        return ScoredStack(ids=self.ids.to(device),
                           swords=_to_torch(self.swords, device, True),
                           bmax=_to_torch(self.bmax, device, False))


def stack_scored(scoreds, n_blocks: int = None,
                 n_words: int = None) -> ScoredStack:
    """Stack ScoredLists into one numpy :class:`ScoredStack` — see
    :func:`stack_packed`."""
    ids = stack_packed([s.ids for s in scoreds], n_blocks, n_words)
    G, nb = len(scoreds), ids.n_blocks
    swords = np.zeros((G, nb * SCORE_WORDS), np.uint32)
    bmax = np.zeros((G, nb), np.int32)
    for g, s in enumerate(scoreds):
        k = s.ids.n_blocks
        if k:
            swords[g, : k * SCORE_WORDS] = np.asarray(s.swords)
            bmax[g, :k] = np.asarray(s.bmax)
    return ScoredStack(ids=ids, swords=swords, bmax=bmax)


def repad_scored(s: ScoredStack, n_blocks: int,
                 n_words: int) -> ScoredStack:
    """Grow a numpy scored stack to a wider shared bucket; new pad blocks
    get zero score planes."""
    ids = repad_stacked(s.ids, n_blocks, n_words)
    nb0 = s.ids.n_blocks
    if nb0 == n_blocks:
        return ScoredStack(ids=ids, swords=s.swords, bmax=s.bmax)
    lead = s.bmax.shape[:-1]
    pad_w = [(0, 0)] * len(lead) + [(0, (n_blocks - nb0) * SCORE_WORDS)]
    pad_b = [(0, 0)] * len(lead) + [(0, n_blocks - nb0)]
    return ScoredStack(ids=ids, swords=np.pad(s.swords, pad_w),
                       bmax=np.pad(s.bmax, pad_b))


def decode_scores(swords: torch.Tensor) -> torch.Tensor:
    """Unpack uint8 impact lanes from score words (int64 holding uint32):
    int32[..., 4 * W] over any leading dims.  One byte plane at a time,
    so no int64 intermediate is wider than the words themselves."""
    lead, w = swords.shape[:-1], swords.shape[-1]
    out = torch.empty(lead + (w, 4), dtype=torch.int32, device=swords.device)
    for b in range(4):
        out[..., b] = (swords >> (8 * b)) & 0xFF
    return out.reshape(lead + (w * 4,))


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------
_LEAF_DTYPES = (("firsts", torch.int64), ("bws", torch.int32),
                ("woffs", torch.int32), ("payload", torch.int64))


def _check_lists(name, s, rows: int, ns) -> None:
    leaves = [getattr(s, f) for f, _ in _LEAF_DTYPES] + [ns]
    _cuda.require_cuda(name, *leaves)
    for f, dt in _LEAF_DTYPES:
        if getattr(s, f).dtype != dt:
            raise TypeError(f"{name}: {f} must be {dt}, got "
                            f"{getattr(s, f).dtype}")
    if ns.dtype != torch.int32 or ns.shape != (rows,):
        raise TypeError(f"{name}: ns must be int32[{rows}]")
    nb = s.firsts.shape[-1]
    for f in ("bws", "woffs"):
        if getattr(s, f).shape != s.firsts.shape:
            raise ValueError(f"{name}: {f} shape != firsts shape")
    if (s.firsts.numel() != rows * nb
            or s.payload.numel() != rows * s.payload.shape[-1]):
        raise ValueError(f"{name}: leaves disagree on the row count")


def _launch(name, a, a_ns, b, b_ns, rows: int, out) -> None:
    nba, nbb = a.firsts.shape[-1], b.firsts.shape[-1]
    err = _cuda.lib().segment_intersect_launch(
        a.firsts.data_ptr(), a.bws.data_ptr(), a.woffs.data_ptr(),
        a.payload.data_ptr(), a_ns.data_ptr(), nba, a.payload.shape[-1],
        b.firsts.data_ptr(), b.bws.data_ptr(), b.woffs.data_ptr(),
        b.payload.data_ptr(), b_ns.data_ptr(), nbb, b.payload.shape[-1],
        out.data_ptr(), rows, _cuda.stream_ptr(out.device))
    _cuda.check(err, name)


def segment_intersect_mask_batched(a: StackedLists,
                                   b: StackedLists) -> torch.Tensor:
    """Row-wise membership masks of a's docids in b over ``[N, ...]``
    stacks (flatten a ``[Q, G]`` batch first): int32[N, a.n_blocks *
    SEG_BLOCK], 1 where lane < a.ns[r] and a's docid occurs in b's row.
    One launch of the CUDA kernel for the whole batch."""
    if a.firsts.dim() != 2 or b.firsts.dim() != 2:
        raise ValueError("stack leaves must be [N, ...]; reshape the "
                         "(Q, G) batch first")
    rows, nba = a.firsts.shape
    if b.firsts.shape[0] != rows:
        raise ValueError(f"row counts differ: {rows} != "
                         f"{b.firsts.shape[0]}")
    name = "segment_intersect_mask_batched"
    _check_lists(name, a, rows, a.ns)
    _check_lists(name, b, rows, b.ns)
    out = torch.empty((rows, nba * SEG_BLOCK), dtype=torch.int32,
                      device=a.firsts.device)
    if rows == 0 or nba == 0:
        return out
    segment_intersect_mask_batched.launches += 1
    _launch(name, a, a.ns, b, b.ns, rows, out)
    return out


segment_intersect_mask_batched.launches = 0


def segment_intersect_mask(a: PackedList, b: PackedList) -> torch.Tensor:
    """Membership mask of a's docids in b, both block-gap-compressed
    (torch leaves on one CUDA device): int32[a.n_blocks * SEG_BLOCK].
    The single-pair form of the batched kernel: one row, each list with
    its own block count and payload stride."""
    dev = a.firsts.device
    if a.n_blocks == 0:
        return torch.zeros((0,), dtype=torch.int32, device=dev)
    if b.n_blocks == 0:
        return torch.zeros((a.n_blocks * SEG_BLOCK,), dtype=torch.int32,
                           device=dev)
    a_ns = torch.full((1,), a.n, dtype=torch.int32, device=dev)
    b_ns = torch.full((1,), b.n, dtype=torch.int32, device=dev)
    name = "segment_intersect_mask"
    _check_lists(name, a, 1, a_ns)
    _check_lists(name, b, 1, b_ns)
    out = torch.empty((a.n_blocks * SEG_BLOCK,), dtype=torch.int32,
                      device=dev)
    segment_intersect_mask.launches += 1
    _launch(name, a, a_ns, b, b_ns, 1, out)
    return out


segment_intersect_mask.launches = 0


_SCORED_DTYPES = (("swords", torch.int64), ("bmax", torch.int32))


def _check_scored(name, s, rows: int) -> None:
    _check_lists(name, s.ids, rows, s.ids.ns)
    _cuda.require_cuda(name, s.ids.firsts, s.swords, s.bmax)
    for f, dt in _SCORED_DTYPES:
        if getattr(s, f).dtype != dt:
            raise TypeError(f"{name}: {f} must be {dt}, got "
                            f"{getattr(s, f).dtype}")
    nb = s.ids.firsts.shape[-1]
    if s.swords.shape != (rows, nb * SCORE_WORDS) or \
            s.bmax.shape != (rows, nb):
        raise ValueError(f"{name}: score planes must be [{rows}, "
                         f"{nb * SCORE_WORDS}] and [{rows}, {nb}]")


def scored_intersect_batched(a: ScoredStack, b: ScoredStack, rest,
                             th) -> torch.Tensor:
    """Row-wise scored conjunction of a's docids with b over ``[N, ...]``
    scored stacks: int32[N, a.n_blocks * SEG_BLOCK] where lane i holds
    ``a_impact + b_impact`` if a's docid i occurs in b and its block's
    WAND bound ``a.bmax + rest`` beats ``th``, else 0.  ``rest``/``th``
    are int32[N] (th = -1 disables skipping).  One launch of the CUDA
    kernel for the whole batch; skipped blocks are never decoded."""
    if a.ids.firsts.dim() != 2 or b.ids.firsts.dim() != 2:
        raise ValueError("stack leaves must be [N, ...]; reshape the "
                         "(Q, G) batch first")
    rows, nba = a.ids.firsts.shape
    if b.ids.firsts.shape[0] != rows:
        raise ValueError(f"row counts differ: {rows} != "
                         f"{b.ids.firsts.shape[0]}")
    name = "scored_intersect_batched"
    _check_scored(name, a, rows)
    _check_scored(name, b, rows)
    _cuda.require_cuda(name, a.ids.firsts, rest, th)
    for t, what in ((rest, "rest"), (th, "th")):
        if t.dtype != torch.int32 or t.shape != (rows,):
            raise TypeError(f"{name}: {what} must be int32[{rows}]")
    out = torch.empty((rows, nba * SEG_BLOCK), dtype=torch.int32,
                      device=a.ids.firsts.device)
    if rows == 0 or nba == 0:
        return out
    scored_intersect_batched.launches += 1
    err = _cuda.lib().scored_intersect_launch(
        a.ids.firsts.data_ptr(), a.ids.bws.data_ptr(),
        a.ids.woffs.data_ptr(), a.ids.payload.data_ptr(),
        a.ids.ns.data_ptr(), a.swords.data_ptr(), a.bmax.data_ptr(), nba,
        a.ids.payload.shape[-1],
        b.ids.firsts.data_ptr(), b.ids.bws.data_ptr(),
        b.ids.woffs.data_ptr(), b.ids.payload.data_ptr(),
        b.ids.ns.data_ptr(), b.swords.data_ptr(), b.ids.firsts.shape[-1],
        b.ids.payload.shape[-1], rest.data_ptr(), th.data_ptr(),
        out.data_ptr(), rows, _cuda.stream_ptr(out.device))
    _cuda.check(err, name)
    return out


scored_intersect_batched.launches = 0
