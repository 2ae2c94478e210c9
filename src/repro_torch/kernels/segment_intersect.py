"""Fused gap-decode + sorted-set intersection over frozen CSR segments.

Frozen read-only segments store each term's docids gap-compressed in
128-docid blocks (a byte-aligned PForDelta-lite: per-block byte width
1/2/4, little-endian gap planes — :func:`pack_docids`).  The host half
of this module packs, stacks and re-pads those lists (numpy, byte for
byte the reference package's layout); the device half decodes them
(:func:`decode_stacked`, plain torch) and intersects them in the CUDA
kernel ``csrc/segment_intersect.cu`` (:func:`segment_intersect_mask`,
:func:`segment_intersect_mask_batched`).

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
