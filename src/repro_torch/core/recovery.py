"""Durable index snapshots + journaled crash recovery for the port's
``LifecycleEngine`` and ``ShardedLifecycleEngine``.

The same two host-side artifacts and one contract as the reference
package, byte for byte, so an archive or journal written by either
package is read by the other:

  * **Snapshot archive** (:func:`snapshot` / :func:`restore`) — one file:
    ``REPROSNAP`` magic, a CRC32-checked JSON manifest (the engine's
    construction config, counters, tiers, stats and the journal
    watermark ``seq``), then every array leaf with its own CRC32.  The
    leaves are the seven ``PoolState`` leaves (stacked ``[S, ...]`` for
    a sharded engine), the history term frequencies and every frozen
    segment's CSR (``frozen/{i}/shard{s}/...`` per shard when sharded),
    written in the
    reference's dtypes (uint32 heap/tail/data, int32 counters, int64
    offsets) through :mod:`repro_torch.core.convert`.  Writes are atomic
    (tmp file + ``os.replace``).
  * **Ingest journal** (:class:`IngestJournal` / :func:`read_journal`) —
    an append-only log of raw arrival batches, ``<QII``-framed per
    record (body length, CRC of the length, CRC of the body) with
    contiguous sequence numbers.  Append THEN apply: only an appended
    batch is acknowledged.  A torn final record is dropped; any other
    damage raises :class:`CorruptSnapshotError`.
  * **Recovery** (:func:`recover`) — restore the snapshot, then replay
    the journal through the ordinary :meth:`LifecycleEngine.ingest`
    (which launches ``bulk_append``), so rollover, reclamation,
    admission and compaction replay deterministically and the recovered
    engine is bit-identical to the uncrashed one.

:func:`engine_fingerprint` digests everything the contract covers into
CRC32s over the reference-dtype leaves, so two engines — of either
package — are bit-identical exactly when their fingerprints are equal.

Manifest keys that only the reference uses (``interpret``,
``batched_kernel``, ``stable_shapes``) are written with neutral values
and ignored on read: none of them changes state or answers.  An engine
restored with ``validate=True`` (from the archive's config or an
override) runs the structural validators on the restored state before
it is returned.  A sharded archive restores only onto a mesh of its own
shard count: docid residue classes ``d % S`` match for that count
alone.

On a rank mesh (one shard per process,
:func:`~repro_torch.core.sharded_index.make_rank_mesh`) every rank
calls each function with the same arguments: :func:`snapshot` gathers
every active leaf's shards in shard order and shard 0's rank writes the
archive (the bytes of the stacked engine's archive of the same stream),
:func:`restore` reads the archive on every rank and keeps the rank's
own shard's rows, :func:`recover` replays the same journal on every
rank, and :func:`engine_fingerprint` digests the gathered state, equal
to the stacked engine's.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import convert
from repro_torch.core import segments as seg_mod
from repro_torch.core.pointers import PoolLayout

SNAP_MAGIC = b"REPROSNAP\x01\n"
JRNL_MAGIC = b"REPROJRNL\x01\n"
FORMAT_VERSION = 1

# manifest header: u64 manifest length + u32 manifest CRC32
_HDR = struct.Struct("<QI")
# journal record frame: u64 body length + u32 CRC32 of the length field
# itself + u32 body CRC32 (a damaged mid-file length cannot pass for a
# torn tail)
_REC = struct.Struct("<QII")
_LEN = struct.Struct("<Q")
_U32 = struct.Struct("<I")

# construction options of the reference engine that the port has no use
# for; written so the reference restores the archive, ignored on read
_REFERENCE_ONLY = {"interpret": None, "batched_kernel": None,
                   "stable_shapes": False}


class CorruptSnapshotError(RuntimeError):
    """A snapshot archive or ingest journal fails an integrity check
    (bad magic, truncation, CRC mismatch, sequence gap, or a journal
    ending short of the durable watermark).  Recovery never proceeds
    past one of these."""


# ---------------------------------------------------------------------------
# Archive container: magic | manifest header | JSON manifest | payload
# ---------------------------------------------------------------------------
def write_archive(path: str, meta: Dict[str, Any],
                  arrays: List[Tuple[str, np.ndarray]]) -> None:
    """Write ``arrays`` (name-ordered) + ``meta`` as one checksummed
    archive, atomically (tmp file + rename)."""
    entries = []
    payload = bytearray()
    for name, arr in arrays:
        arr = np.asarray(arr)
        raw = arr.tobytes()           # keeps 0-d leaves 0-d in the shape
        entries.append({"name": name, "dtype": str(arr.dtype),
                        "shape": list(arr.shape),
                        "offset": len(payload), "nbytes": len(raw),
                        "crc32": zlib.crc32(raw)})
        payload += raw
    manifest = json.dumps({"meta": meta, "arrays": entries},
                          sort_keys=True).encode()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(SNAP_MAGIC)
        f.write(_HDR.pack(len(manifest), zlib.crc32(manifest)))
        f.write(manifest)
        f.write(bytes(payload))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_archive(path: str) -> Tuple[Dict[str, Any],
                                     Dict[str, np.ndarray]]:
    """Read + verify an archive.  Raises :class:`CorruptSnapshotError` on
    bad magic, a truncated manifest or payload, or any CRC mismatch."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as exc:
        raise CorruptSnapshotError(f"cannot read snapshot {path}: {exc}")
    if len(blob) < len(SNAP_MAGIC) + _HDR.size:
        raise CorruptSnapshotError(
            f"{path}: {len(blob)} bytes is shorter than the archive "
            f"header — truncated snapshot")
    if blob[: len(SNAP_MAGIC)] != SNAP_MAGIC:
        raise CorruptSnapshotError(
            f"{path}: bad magic {blob[:len(SNAP_MAGIC)]!r} — not a "
            f"repro snapshot archive")
    mlen, mcrc = _HDR.unpack_from(blob, len(SNAP_MAGIC))
    mstart = len(SNAP_MAGIC) + _HDR.size
    manifest = blob[mstart: mstart + mlen]
    if len(manifest) != mlen:
        raise CorruptSnapshotError(
            f"{path}: manifest truncated ({len(manifest)}/{mlen} bytes)")
    if zlib.crc32(manifest) != mcrc:
        raise CorruptSnapshotError(f"{path}: manifest CRC mismatch")
    try:
        doc = json.loads(manifest)
    except ValueError as exc:
        raise CorruptSnapshotError(f"{path}: manifest not JSON: {exc}")
    payload = blob[mstart + mlen:]
    arrays: Dict[str, np.ndarray] = {}
    for e in doc["arrays"]:
        raw = payload[e["offset"]: e["offset"] + e["nbytes"]]
        if len(raw) != e["nbytes"]:
            raise CorruptSnapshotError(
                f"{path}: leaf {e['name']!r} truncated "
                f"({len(raw)}/{e['nbytes']} bytes)")
        if zlib.crc32(raw) != e["crc32"]:
            raise CorruptSnapshotError(
                f"{path}: leaf {e['name']!r} CRC mismatch — corrupted "
                f"payload byte(s)")
        arr = np.frombuffer(raw, dtype=np.dtype(e["dtype"]))
        want = int(np.prod(e["shape"], dtype=np.int64))
        if arr.size != want:
            raise CorruptSnapshotError(
                f"{path}: leaf {e['name']!r} holds {arr.size} elements, "
                f"manifest shape {e['shape']} wants {want}")
        arrays[e["name"]] = arr.reshape(e["shape"]).copy()
    return doc["meta"], arrays


# ---------------------------------------------------------------------------
# Engine serialization
# ---------------------------------------------------------------------------
def _engine_kind(engine) -> str:
    from repro_torch.core import lifecycle as lc
    if isinstance(engine, lc.ShardedLifecycleEngine):
        return "sharded"
    if isinstance(engine, lc.LifecycleEngine):
        return "single"
    raise TypeError(f"cannot snapshot {type(engine).__name__}; expected "
                    f"LifecycleEngine or ShardedLifecycleEngine")


def _collected_leaves(segs) -> Optional[Dict[str, np.ndarray]]:
    """The active state's leaves in the reference's dtypes, every shard,
    where the archive is written: on a rank mesh each rank sends its
    rows to shard 0's rank (:meth:`RankMesh.collect`, from host memory,
    as the bits of those dtypes: uint32 as int32, bool as uint8), which
    gets them in shard order, and the other ranks get ``None``."""
    leaves = convert.pool_state_to_numpy(segs.active.state)
    mesh = getattr(segs, "mesh", None)
    if mesh is None:
        return leaves
    out = {}
    for name, a in leaves.items():
        bits = np.ascontiguousarray(a).view(
            {1: np.uint8, 4: np.int32, 8: np.int64}[a.itemsize])
        got = mesh.collect(torch.from_numpy(bits))
        out[name] = None if got is None else got.numpy().view(a.dtype)
    return None if any(v is None for v in out.values()) else out


def snapshot(engine, path: str, *, seq: int = 0) -> Dict[str, Any]:
    """Serialize the engine's full state to ``path``; returns the meta
    dict written into the manifest.  ``seq`` is the journal watermark:
    the number of ingest batches applied so far (:func:`recover`
    replays records with ``seq >=`` it).  On a rank mesh shard 0's rank
    writes, and every rank returns once the file is in place."""
    kind = _engine_kind(engine)
    segs = engine.segments
    policy = segs.compaction
    admission = engine.admission
    cfg = {
        "z": list(engine.layout.z),
        "slices_per_pool": list(engine.layout.slices_per_pool),
        "vocab_size": int(engine.vocab_size),
        "docs_per_segment": int(segs.docs_per_segment),
        "max_slices": int(engine.max_slices),
        "max_len": int(engine.max_len),
        "max_query_len": int(engine.max_query_len),
        "max_segments": int(segs.max_segments),
        "use_kernel": bool(engine.use_kernel),
        "bulk_ingest": bool(segs.bulk_ingest),
        "batched": bool(engine.batched),
        "validate": bool(engine.validate),
        "compaction_fanout": (int(policy.fanout)
                              if policy is not None else None),
        "admission": (dataclasses.asdict(admission)
                      if admission is not None else None),
        **_REFERENCE_ONLY,
    }
    meta = {
        "format": FORMAT_VERSION,
        "kind": kind,
        "num_shards": (int(segs.num_shards) if kind == "sharded" else 1),
        "config": cfg,
        "active": {"next_docid": int(segs.active.next_docid)},
        "segments": {"doc_base": int(segs._doc_base),
                     "n_rollovers": int(segs.n_rollovers),
                     "n_compactions": int(segs.n_compactions)},
        "frozen": [{"n_docs": int(fz.n_docs), "doc_base": int(fz.doc_base),
                    "tier": int(fz.tier)} for fz in segs.frozen],
        "has_hist_freqs": segs._hist_freqs is not None,
        "stats": dataclasses.asdict(engine.stats),
        "seq": int(seq),
    }
    leaves = _collected_leaves(segs)
    failed = None
    if leaves is not None:
        arrays: List[Tuple[str, np.ndarray]] = [
            (f"active/{name}", leaf) for name, leaf in leaves.items()]
        if segs._hist_freqs is not None:
            arrays.append(("hist_freqs",
                           np.asarray(segs._hist_freqs, np.int64)))
        for i, fz in enumerate(segs.frozen):
            for s, member in enumerate(fz.members):
                prefix = (f"frozen/{i}/shard{s}" if kind == "sharded"
                          else f"frozen/{i}")
                arrays.append((f"{prefix}/offsets",
                               np.asarray(member.offsets, np.int64)))
                arrays.append((f"{prefix}/data",
                               np.asarray(member.data, np.uint32)))
        try:
            write_archive(path, meta, arrays)
        except OSError as exc:
            failed = exc
    # every rank returns once the file is in place, or raises
    mesh = getattr(segs, "mesh", None)
    if mesh is not None and mesh.combine(failed is not None, "max") \
            and failed is None:
        raise OSError(f"shard 0's rank could not write the snapshot {path}")
    if failed is not None:
        raise failed
    return meta


def _leaf(arrays: Dict[str, np.ndarray], name: str) -> np.ndarray:
    """One archive leaf, or :class:`CorruptSnapshotError` if the
    manifest lacks it."""
    arr = arrays.get(name)
    if arr is None:
        raise CorruptSnapshotError(f"archive lacks leaf {name}")
    return arr


def _build_engine(meta: Dict[str, Any], arrays: Dict[str, np.ndarray],
                  *, device, mesh=None, **overrides):
    """Rebuild a port engine from archive contents (shared by
    :func:`restore` and :func:`recover`)."""
    from repro_torch.core import lifecycle as lc
    from repro_torch.core import sharded_index as shx

    kind = meta["kind"]
    if kind not in ("single", "sharded"):
        raise CorruptSnapshotError(f"unknown archive kind {kind!r}")
    cfg = dict(meta["config"])
    for key in _REFERENCE_ONLY:
        cfg.pop(key, None)
    layout = PoolLayout(z=tuple(cfg.pop("z")),
                        slices_per_pool=tuple(cfg.pop("slices_per_pool")))
    fanout = cfg.pop("compaction_fanout")
    adm_cfg = cfg.pop("admission")
    kwargs = dict(
        max_slices=cfg["max_slices"], max_len=cfg["max_len"],
        max_query_len=cfg["max_query_len"],
        max_segments=cfg["max_segments"], use_kernel=cfg["use_kernel"],
        bulk_ingest=cfg["bulk_ingest"], batched=cfg["batched"],
        validate=cfg["validate"],
        compaction=(seg_mod.CompactionPolicy(fanout=fanout)
                    if fanout is not None else None),
        admission=(lc.AdmissionController(**adm_cfg)
                   if adm_cfg is not None else None),
    )
    kwargs.update(overrides)
    if kind == "sharded":
        S = int(meta["num_shards"])
        if mesh is None:
            mesh = shx.make_doc_mesh(S, device=device)
        if mesh.num_shards != S:
            raise ValueError(
                f"snapshot was taken on {S} shards but the mesh "
                f"provides {mesh.num_shards}; docid residue "
                f"classes d % S only match for the same shard count")
        eng = lc.ShardedLifecycleEngine(
            layout, cfg["vocab_size"], cfg["docs_per_segment"], mesh,
            device=device, **kwargs)
    else:
        eng = lc.LifecycleEngine(layout, cfg["vocab_size"],
                                 cfg["docs_per_segment"], device=device,
                                 **kwargs)

    # -- active pool: every PoolState leaf (a rank mesh's own shard's
    # rows), checked against the engine's
    init = convert.pool_state_to_numpy(eng.segments.active.state)
    leaves = {}
    for name, ref in init.items():
        arr = _leaf(arrays, f"active/{name}")
        if kind == "sharded":    # the mesh's local shards: consecutive rows
            lo = eng.segments.mesh.local_shards[0]
            arr = arr[lo: lo + ref.shape[0]]
        if arr.shape != ref.shape or arr.dtype != ref.dtype:
            raise CorruptSnapshotError(
                f"leaf active/{name}: archive {arr.dtype}{arr.shape} "
                f"does not match the engine's {ref.dtype}{ref.shape}")
        leaves[name] = arr

    def csr(pre, n_docs, fm):
        return dict(offsets=_leaf(arrays, f"{pre}/offsets"),
                    data=_leaf(arrays, f"{pre}/data"), n_docs=n_docs,
                    doc_base=fm["doc_base"], tier=fm["tier"])

    frozen = []
    for i, fm in enumerate(meta["frozen"]):
        if kind == "sharded":
            S = int(meta["num_shards"])
            frozen.append(dict(
                shards=[csr(f"frozen/{i}/shard{s}", fm["n_docs"] // S, fm)
                        for s in range(S)],
                n_docs=fm["n_docs"], doc_base=fm["doc_base"],
                tier=fm["tier"]))
        else:
            frozen.append(csr(f"frozen/{i}", fm["n_docs"], fm))
    segs_meta = meta["segments"]
    # installs the state, the frozen CSRs (freed_slices stays None: the
    # slices were recycled at the original rollover) and the counters,
    # then re-syncs the packed query views
    convert.load_lifecycle(
        eng, leaves, frozen, next_docid=meta["active"]["next_docid"],
        doc_base=segs_meta["doc_base"],
        n_rollovers=segs_meta["n_rollovers"],
        n_compactions=segs_meta["n_compactions"])
    eng.segments._hist_freqs = (_leaf(arrays, "hist_freqs")
                                if meta.get("has_hist_freqs") else None)
    for k, v in meta["stats"].items():
        if hasattr(eng.stats, k):
            setattr(eng.stats, k, v)
    # a checksummed but structurally broken archive fails here, not at
    # the first wrong query result
    if eng.validate:
        eng.validate_invariants()
    return eng


def restore(path: str, *, mesh=None, device="cuda", **overrides):
    """Rebuild a port :class:`~repro_torch.core.lifecycle.LifecycleEngine`
    (or, from a sharded archive, a ``ShardedLifecycleEngine``) on
    ``device`` from a snapshot archive written by either package.
    ``mesh`` is used only by sharded archives: ``None`` builds
    ``make_doc_mesh(S, device=device)`` over the saved shard count, a
    rank mesh (``make_rank_mesh``) keeps this rank's shard, and a mesh
    of another shard count raises ``ValueError``.  ``overrides``
    are constructor keyword overrides (e.g. ``use_kernel=False``,
    ``validate=True``); with ``validate`` the structural validators run
    on the restored state."""
    meta, arrays = read_archive(path)
    return _build_engine(meta, arrays, device=device, mesh=mesh,
                         **overrides)


# ---------------------------------------------------------------------------
# Ingest journal: append-only WAL of raw arrival batches
# ---------------------------------------------------------------------------
def _pack_record(seq: int, docs: np.ndarray) -> bytes:
    hdr = json.dumps({"seq": int(seq), "dtype": str(docs.dtype),
                      "shape": list(docs.shape)},
                     sort_keys=True).encode()
    body = _U32.pack(len(hdr)) + hdr + docs.tobytes()
    return _REC.pack(len(body), zlib.crc32(_LEN.pack(len(body))),
                     zlib.crc32(body)) + body


class IngestJournal:
    """Append-only host-side log of raw ingest batches.

    Contract (WAL-then-apply): ``journal.append(docs)`` BEFORE
    ``engine.ingest(docs)``; only an appended batch may be acknowledged.
    A crash mid-append leaves a torn final record, which
    :func:`read_journal` drops; a crash between append and apply leaves
    a complete record that replay applies.  Opening an existing journal
    resumes it: a torn tail is truncated away first, and appends
    continue from the next sequence number.  ``fsync=True`` adds an
    ``os.fsync`` per append (power-loss durability); the default flush
    survives a process crash.
    """

    def __init__(self, path: str, *, base_seq: int = 0,
                 fsync: bool = False):
        self.path = path
        self.fsync = bool(fsync)
        if os.path.exists(path) and os.path.getsize(path) > 0:
            base, records, end = _parse_journal(path)
            self.next_seq = base + len(records)
            self._f = open(path, "rb+")
            self._f.truncate(end)
            self._f.seek(end)
        else:
            self.next_seq = int(base_seq)
            self._f = open(path, "wb")
            hdr = json.dumps({"format": FORMAT_VERSION,
                              "base_seq": int(base_seq)},
                             sort_keys=True).encode()
            self._f.write(JRNL_MAGIC)
            self._f.write(_HDR.pack(len(hdr), zlib.crc32(hdr)))
            self._f.write(hdr)
            self._flush()

    def _flush(self) -> None:
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def append(self, docs) -> int:
        """Append one raw arrival batch (flushed before returning);
        returns its sequence number."""
        docs = np.ascontiguousarray(np.asarray(docs))
        seq = self.next_seq
        self._f.write(_pack_record(seq, docs))
        self._flush()
        self.next_seq += 1
        return seq

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "IngestJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _parse_journal(path: str) -> Tuple[int, List[Tuple[int, np.ndarray]],
                                       int]:
    """``(base_seq, [(seq, docs), ...], end)``; ``end`` is the byte
    offset just past the last complete record."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as exc:
        raise CorruptSnapshotError(f"cannot read journal {path}: {exc}")
    if len(blob) < len(JRNL_MAGIC) + _HDR.size:
        raise CorruptSnapshotError(
            f"{path}: {len(blob)} bytes is shorter than the journal "
            f"header")
    if blob[: len(JRNL_MAGIC)] != JRNL_MAGIC:
        raise CorruptSnapshotError(
            f"{path}: bad magic — not a repro ingest journal")
    hlen, hcrc = _HDR.unpack_from(blob, len(JRNL_MAGIC))
    hstart = len(JRNL_MAGIC) + _HDR.size
    hdr = blob[hstart: hstart + hlen]
    if len(hdr) != hlen or zlib.crc32(hdr) != hcrc:
        raise CorruptSnapshotError(f"{path}: journal header damaged")
    base_seq = int(json.loads(hdr)["base_seq"])

    records: List[Tuple[int, np.ndarray]] = []
    pos = hstart + hlen
    while pos < len(blob):
        if len(blob) - pos < _REC.size:
            break                      # torn tail: partial record frame
        body_len, len_crc, crc = _REC.unpack_from(blob, pos)
        # a crash truncates; it never leaves a complete frame header with
        # damaged bytes, so a bad length checksum is corruption
        if zlib.crc32(blob[pos: pos + _LEN.size]) != len_crc:
            raise CorruptSnapshotError(
                f"{path}: record frame at byte {pos} has a damaged "
                f"length field — journal corruption, not a torn append")
        body = blob[pos + _REC.size: pos + _REC.size + body_len]
        at_eof = pos + _REC.size + body_len >= len(blob)
        if len(body) != body_len:
            break                      # torn tail: payload cut short
        if zlib.crc32(body) != crc:
            if at_eof:
                break                  # torn tail: crash mid-append
            raise CorruptSnapshotError(
                f"{path}: record at byte {pos} fails CRC with records "
                f"after it — journal corruption, not a torn append")
        rhlen, = _U32.unpack_from(body, 0)
        rhdr = json.loads(body[_U32.size: _U32.size + rhlen])
        raw = body[_U32.size + rhlen:]
        docs = np.frombuffer(raw, dtype=np.dtype(rhdr["dtype"]))
        want = int(np.prod(rhdr["shape"], dtype=np.int64))
        if docs.size != want:
            raise CorruptSnapshotError(
                f"{path}: record seq {rhdr['seq']} holds {docs.size} "
                f"elements, header shape {rhdr['shape']} wants {want}")
        seq = int(rhdr["seq"])
        if seq != base_seq + len(records):
            raise CorruptSnapshotError(
                f"{path}: record sequence jumps to {seq}, expected "
                f"{base_seq + len(records)} — missing or reordered "
                f"records")
        records.append((seq, docs.reshape(rhdr["shape"]).copy()))
        pos += _REC.size + body_len
    return base_seq, records, pos


def read_journal(path: str) -> Tuple[int, List[Tuple[int, np.ndarray]]]:
    """Parse a journal into ``(base_seq, [(seq, docs), ...])``.  A torn
    final record is dropped silently; any other damage raises
    :class:`CorruptSnapshotError`."""
    base_seq, records, _ = _parse_journal(path)
    return base_seq, records


# ---------------------------------------------------------------------------
# Recovery: restore + replay
# ---------------------------------------------------------------------------
def recover(snapshot_path: str, journal_path: Optional[str] = None, *,
            mesh=None, expect_seq: Optional[int] = None, on_replay=None,
            device="cuda", **overrides):
    """Restore the snapshot on ``device`` (a sharded one on ``mesh``, as
    :func:`restore` does), then replay journaled batches through the
    ordinary ingest path.  Returns the recovered engine.

    ``expect_seq`` is the durable watermark (the number of batches
    acknowledged upstream): if snapshot + journal cover fewer,
    :class:`CorruptSnapshotError` is raised.  ``on_replay(seq, docs,
    admitted)`` is called after each replayed batch."""
    meta, arrays = read_archive(snapshot_path)
    eng = _build_engine(meta, arrays, device=device, mesh=mesh,
                        **overrides)
    applied = int(meta["seq"])
    if journal_path is not None and os.path.exists(journal_path):
        _, records = read_journal(journal_path)
        for seq, docs in records:
            if seq < applied:
                continue               # journal predates this snapshot
            if seq > applied:
                raise CorruptSnapshotError(
                    f"{journal_path}: first replayable record is seq "
                    f"{seq} but the snapshot was taken at seq {applied} "
                    f"— journal records between them are missing")
            ok = eng.ingest(docs)
            applied += 1
            if on_replay is not None:
                on_replay(seq, docs, ok)
    if expect_seq is not None and applied < int(expect_seq):
        raise CorruptSnapshotError(
            f"recovery covers only {applied} batches but the durable "
            f"watermark acknowledges {int(expect_seq)} — the journal "
            f"tail is missing")
    return eng


# ---------------------------------------------------------------------------
# Bit-identity fingerprint
# ---------------------------------------------------------------------------
def _crc(arr) -> int:
    return zlib.crc32(np.ascontiguousarray(np.asarray(arr)).tobytes())


def _gf2_times(mat: List[int], vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat: List[int]) -> List[int]:
    return [_gf2_times(mat, m) for m in mat]


def _crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """zlib's ``crc32_combine`` (Python's ``zlib`` does not expose it):
    the CRC32 of ``A + B`` from ``crc32(A)``, ``crc32(B)`` and
    ``len(B)``, by appending ``len(B)`` zero bytes to ``crc1`` with
    squared GF(2) operators."""
    odd = [0xEDB88320] + [1 << n for n in range(31)]   # one zero bit
    even = _gf2_square(odd)                            # two
    odd = _gf2_square(even)                            # four
    while len2 > 0:
        even = _gf2_square(odd)        # one zero byte, then doubling
        if len2 & 1:
            crc1 = _gf2_times(even, crc1)
        len2 >>= 1
        if not len2:
            break
        odd = _gf2_square(even)
        if len2 & 1:
            crc1 = _gf2_times(odd, crc1)
        len2 >>= 1
    return crc1 ^ crc2


def _active_crcs(segs) -> Dict[str, int]:
    """``_crc`` of each active leaf in the reference's dtypes, every
    shard: each process CRCs its own rows, and on a rank mesh the
    ranks' ``(crc, bytes)`` pairs are all-gathered and joined in shard
    order (:func:`_crc32_combine`), so no rank needs another's rows."""
    leaves = convert.pool_state_to_numpy(segs.active.state)
    parts = torch.tensor([[[_crc(a), a.nbytes] for a in leaves.values()]],
                         dtype=torch.int64)
    mesh = getattr(segs, "mesh", None)
    if mesh is not None:
        parts = mesh.stack(parts)
    out = {}
    for j, name in enumerate(leaves):
        (crc, _), *rest = parts[:, j].tolist()
        for c, n in rest:
            crc = _crc32_combine(crc, c, n)
        out[f"active/{name}"] = crc
    return out


def engine_fingerprint(engine) -> Dict[str, Any]:
    """CRC32 digest of everything the recovery contract reproduces
    bit for bit — every active ``PoolState`` leaf (in the reference's
    dtypes), every frozen CSR with its docid range and tier, the
    lifecycle counters and stats — equal to the reference package's
    ``engine_fingerprint`` of the same state.  Take it before scored
    queries, which bump the block-skip stats."""
    segs = engine.segments
    fp: Dict[str, Any] = dict(_active_crcs(segs))
    fp["next_docid"] = int(segs.active.next_docid)
    fp["doc_base"] = int(segs._doc_base)
    fp["n_rollovers"] = int(segs.n_rollovers)
    fp["n_compactions"] = int(segs.n_compactions)
    fp["hist_freqs"] = (None if segs._hist_freqs is None
                        else _crc(np.asarray(segs._hist_freqs, np.int64)))
    for i, fz in enumerate(segs.frozen):
        fp[f"frozen/{i}"] = (int(fz.doc_base), int(fz.n_docs),
                             int(fz.tier),
                             tuple((_crc(m.offsets), _crc(m.data))
                                   for m in fz.members))
    fp["n_frozen"] = len(segs.frozen)
    fp["stats"] = dataclasses.asdict(engine.stats)
    return fp


__all__ = ["CorruptSnapshotError", "IngestJournal", "engine_fingerprint",
           "read_archive", "read_journal", "recover", "restore",
           "snapshot", "write_archive"]
