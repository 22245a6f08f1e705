"""Crash-consistent durability: write-ahead log, atomic checkpoints,
fingerprint-verified recovery — the port of the JAX package's
``core/durability.py``, in its byte format: a WAL or checkpoint written
by either package is recovered by the other, with an equal
``index_state_fingerprint``.  The recovered index lives on the device
the caller names.

Replay determinism from the engine-lock admission order and
rollback-consistent maintenance are memory-resident promises; this
module makes them hold across crashes:

  * :class:`WriteAheadLog` — framed, CRC32-checksummed, length-prefixed
    records appended *before* the index mutation they describe, in the
    engine-lock total order, so single-threaded replay of the log suffix
    reproduces the live index byte-identically (the admission-log
    property, now on disk).  ``fsync`` policy is configurable:
    ``always`` (fsync per append), ``batch`` (every ``batch_ops``
    appends), ``off`` (never — the OS page cache decides what survives).
  * checkpoints — per-partition blobs plus a JSON manifest, written into
    a temp directory, fsynced file-by-file, then atomically
    ``os.rename``d into place.  Generation-numbered; journal-dirty-set
    driven, so partitions untouched since the previous generation are
    hard-linked instead of rewritten.
  * :func:`recover_index` — selects the newest checkpoint that passes
    CRC + manifest validation, replays the WAL suffix past the
    checkpoint's LSN, truncates any torn tail to the last valid prefix,
    and verifies the result against the manifest's stored
    ``index_state_fingerprint``.

Crash model (exercised by the fault sites in ``faults``): a crash may
tear the
last WAL frame at any byte, flip bits in an unsynced frame, lose any
suffix of unsynced bytes, or abort a checkpoint before its rename.  In
every case recovery lands on a *prefix* of the admitted write sequence
and proves it with the fingerprint.

Thread-safety: none of the classes here carry their own lock.  Every
mutating call happens under ``ServingRuntime._engine_lock`` — the WAL
append must be ordered by the same total order as the index mutation it
logs, so a separate lock could only create ordering bugs, not fix them.
Counter attributes are GIL-atomic scalars; ``stats()`` may read them
from any thread.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import shutil
import struct
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..faults import InjectedFault, index_state_fingerprint
from .index import Level, QuakeConfig, QuakeIndex

__all__ = [
    "WAL_MAGIC", "WAL_NAME", "REC_INSERT", "REC_DELETE", "REC_MAINT",
    "REC_FP", "WalRecord", "read_wal", "WriteAheadLog",
    "write_checkpoint", "validate_checkpoint", "select_checkpoint",
    "list_checkpoints", "load_checkpoint", "save_index", "recover_index",
    "RecoveryError", "RecoveryReport", "DurabilityManager",
]

# --------------------------------------------------------------------------
# WAL record format (docs/durability.md)
#
#   file   = magic, frame*
#   frame  = crc32:u32le, body
#   body   = payload_len:u32le, lsn:u64le, rtype:u8, payload
#
# crc32 covers the whole body (header included), so a bit flip in the
# length or LSN fields fails the checksum just like one in the payload.
# LSNs are strictly increasing within a file; the reader stops at the
# first frame that is short, checksum-invalid, or LSN-regressive, and
# reports the byte offset of the last valid prefix.
# --------------------------------------------------------------------------

WAL_MAGIC = b"QWAL1\n\x00\x00"
WAL_NAME = "wal.log"
_CRC = struct.Struct("<I")
_BODY_HDR = struct.Struct("<IQB")        # payload_len, lsn, rtype

REC_INSERT = 1     # payload: npy(x float32 (n,d)), npy(ids int64 (n,))
REC_DELETE = 2     # payload: npy(ids int64 (n,))
REC_MAINT = 3      # payload: utf-8 reason; informational on replay
REC_FP = 4         # payload: raw sha256 index_state_fingerprint digest
REC_NAMES = {REC_INSERT: "insert", REC_DELETE: "delete",
             REC_MAINT: "maint", REC_FP: "fingerprint"}


def _pack_arrays(*arrays: np.ndarray) -> bytes:
    """Concatenated ``.npy`` serialization (pickle-free) of ``arrays``."""
    buf = io.BytesIO()
    for a in arrays:
        np.save(buf, np.ascontiguousarray(a), allow_pickle=False)
    return buf.getvalue()


def _unpack_arrays(data: bytes, n: int) -> List[np.ndarray]:
    buf = io.BytesIO(data)
    return [np.load(buf, allow_pickle=False) for _ in range(n)]


@dataclass(frozen=True)
class WalRecord:
    lsn: int
    rtype: int
    payload: bytes


def read_wal(path: str) -> Tuple[List[WalRecord], int, str]:
    """Parse a WAL file, stopping at the first invalid frame.

    Returns ``(records, valid_bytes, reason)`` where ``valid_bytes`` is
    the length of the longest valid prefix (magic included) and
    ``reason`` is why parsing stopped: ``clean`` (whole file valid),
    ``missing``, ``short_magic`` / ``bad_magic``, ``torn_header`` /
    ``torn_payload`` (frame cut short), ``crc_mismatch``, or
    ``lsn_regression``.  Never raises on corrupt input — a torn or
    bit-flipped tail is the expected post-crash state, and the valid
    prefix is the recovery contract.
    """
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return [], 0, "missing"
    if len(data) < len(WAL_MAGIC):
        return [], 0, "short_magic"
    if data[: len(WAL_MAGIC)] != WAL_MAGIC:
        return [], 0, "bad_magic"
    off = len(WAL_MAGIC)
    records: List[WalRecord] = []
    reason = "clean"
    head = _CRC.size + _BODY_HDR.size
    while off < len(data):
        if off + head > len(data):
            reason = "torn_header"
            break
        (crc,) = _CRC.unpack_from(data, off)
        plen, lsn, rtype = _BODY_HDR.unpack_from(data, off + _CRC.size)
        end = off + head + plen
        if end > len(data):
            reason = "torn_payload"
            break
        body = data[off + _CRC.size:end]
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            reason = "crc_mismatch"
            break
        if records and lsn <= records[-1].lsn:
            reason = "lsn_regression"
            break
        records.append(WalRecord(lsn=lsn, rtype=rtype,
                                 payload=data[off + head:end]))
        off = end
    return records, off if reason != "clean" else len(data), reason


class WriteAheadLog:
    """Append-only framed log with a configurable fsync policy.

    Opening an existing file truncates any invalid tail back to the
    last valid prefix (the crash-recovery contract) and continues LSNs
    after the last surviving record.  ``faults`` wires in the
    ``wal_torn_write`` / ``wal_corrupt_record`` / ``fsync_dropped``
    sites; the first two model a crash mid-append (they leave a
    damaged tail and raise :class:`InjectedFault`), after which the log
    refuses further appends — the process is considered dead and must
    recover.
    """

    def __init__(self, path: str, fsync: str = "batch", batch_ops: int = 32,
                 faults=None):
        if fsync not in ("always", "batch", "off"):
            raise ValueError(f"fsync policy must be always|batch|off, "
                             f"got {fsync!r}")
        self.path = path
        self.policy = fsync
        self.batch_ops = max(int(batch_ops), 1)
        self.faults = faults
        self.appends = 0
        self.bytes_written = 0
        self.fsyncs = 0
        self.fsyncs_dropped = 0
        self.torn_writes = 0
        self.corrupt_writes = 0
        self._pending_ops = 0
        self._poisoned = False

        records, valid, reason = read_wal(path)
        self.open_reason = reason
        self.last_lsn = records[-1].lsn if records else 0
        self.truncated_on_open = 0
        if reason not in ("clean", "missing"):
            size = os.path.getsize(path)
            self.truncated_on_open = size - valid
            with open(path, "r+b") as f:
                f.truncate(valid)
                f.flush()
                os.fsync(f.fileno())
        self._f = open(path, "ab")
        pre = self._f.tell()
        if pre == 0:
            self._f.write(WAL_MAGIC)
            self._f.flush()
        # bytes that existed before this process are already on disk
        self._synced_size = pre
        self._fsync()

    # -- durability --------------------------------------------------------

    def _fsync(self) -> bool:
        """fsync the log; returns False when the ``fsync_dropped`` fault
        eats it (the policy *believes* it synced — the insidious failure
        mode — so the batch counter resets either way, but
        ``_synced_size`` only advances on a real fsync)."""
        self._pending_ops = 0
        if self.faults is not None and self.faults.fire("fsync_dropped"):
            self.fsyncs_dropped += 1
            return False
        self._f.flush()
        os.fsync(self._f.fileno())
        self.fsyncs += 1
        self._synced_size = self._f.tell()
        return True

    def sync(self) -> bool:
        """Force an fsync regardless of policy."""
        return self._fsync()

    @property
    def unsynced_bytes(self) -> int:
        return (self._f.tell() - self._synced_size) if self._f else 0

    # -- appending ---------------------------------------------------------

    def append(self, rtype: int, payload: bytes) -> int:
        """Frame and append one record; returns its LSN.  Must be called
        under the engine lock, *before* the index mutation it logs."""
        if self._f is None:
            raise RuntimeError("WAL is closed")
        if self._poisoned:
            raise RuntimeError(
                "WAL tail damaged by an injected crash; the process is "
                "considered dead — recover before appending")
        lsn = self.last_lsn + 1
        body = _BODY_HDR.pack(len(payload), lsn, rtype) + payload
        frame = _CRC.pack(zlib.crc32(body) & 0xFFFFFFFF) + body
        if self.faults is not None and self.faults.fire("wal_torn_write"):
            # crash mid-write: a strict prefix of the frame reaches the
            # file (cut point derived from the frame, so deterministic)
            cut = 1 + zlib.crc32(b"torn" + body) % (len(frame) - 1)
            self._f.write(frame[:cut])
            self._f.flush()
            self.torn_writes += 1
            self._poisoned = True
            raise InjectedFault("wal_torn_write", self.torn_writes)
        if self.faults is not None and self.faults.fire("wal_corrupt_record"):
            # bit flip in the written frame (bad sector / firmware bug)
            k = zlib.crc32(b"flip" + body) % len(frame)
            bad = bytearray(frame)
            bad[k] ^= 0x40
            self._f.write(bytes(bad))
            self._f.flush()
            self.corrupt_writes += 1
            self._poisoned = True
            raise InjectedFault("wal_corrupt_record", self.corrupt_writes)
        self._f.write(frame)
        self._f.flush()
        self.last_lsn = lsn
        self.appends += 1
        self.bytes_written += len(frame)
        self._pending_ops += 1
        if self.policy == "always" or (self.policy == "batch"
                                       and self._pending_ops >= self.batch_ops):
            self._fsync()
        return lsn

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        if self._f is None:
            return
        if not self._poisoned:
            self._fsync()
        self._f.close()
        self._f = None

    def simulate_crash(self, keep_unsynced: int = 0) -> int:
        """Model a process/OS crash: everything fsynced survives, plus at
        most ``keep_unsynced`` bytes of the flushed-but-unsynced tail
        (the page cache wrote back a prefix before power cut).  Truncates
        the file accordingly, closes the log, and returns the surviving
        size."""
        if self._f is None:
            raise RuntimeError("WAL is closed")
        size = self._f.tell()
        self._f.close()
        self._f = None
        keep = min(max(int(keep_unsynced), 0),
                   max(size - self._synced_size, 0))
        survive = self._synced_size + keep
        # quakecheck: allow-nosync(simulating post-crash disk state)
        with open(self.path, "r+b") as f:
            f.truncate(survive)
        return survive


# --------------------------------------------------------------------------
# Checkpoints
#
#   <root>/ckpt-<generation:08d>/
#       p<j:06d>-g<gen:08d>.bin    npy(ids int64), npy(vectors f32)
#       meta-g<gen:08d>.bin        per-level centroids + children arrays
#       MANIFEST.json              generation, wal_lsn, fingerprint, CRCs
#
# Written into a ".tmp-" sibling, every file fsynced, the directory
# fsynced, then atomically renamed into place: a crash at any point
# leaves either no ckpt-N directory or a complete one.  Partition blobs
# keep the generation that wrote them in their *name*, so an unchanged
# partition is hard-linked from the previous generation (same inode,
# zero bytes rewritten) and the manifest's name list still identifies it.
# --------------------------------------------------------------------------

CKPT_FORMAT = 1
CKPT_PREFIX = "ckpt-"
TMP_PREFIX = ".tmp-"
MANIFEST_NAME = "MANIFEST.json"


def _fsync_dir(path: str) -> None:
    """fsync a directory so its entries (renames included) are durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_blob(path: str, data: bytes) -> int:
    """Write + flush + fsync one file; returns its CRC32."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    return zlib.crc32(data) & 0xFFFFFFFF


def _part_blob(lvl0: Level, j: int) -> bytes:
    return _pack_arrays(np.asarray(lvl0.ids[j], dtype=np.int64),
                        np.ascontiguousarray(lvl0.vectors[j],
                                             dtype=np.float32))


def write_checkpoint(index: QuakeIndex, root: str, generation: int,
                     wal_lsn: int, write_op_count: int,
                     dirty: Optional[Set[int]] = None,
                     prev_manifest: Optional[dict] = None,
                     prev_dir: Optional[str] = None,
                     faults=None) -> Tuple[dict, dict]:
    """Write generation ``generation`` atomically; returns
    ``(manifest, stats)``.

    ``dirty`` (with ``prev_manifest``/``prev_dir``) enables the
    incremental path: base-level partitions *not* in ``dirty`` are
    hard-linked from the previous generation instead of rewritten (CRC
    carried over from the previous manifest).  Pass ``dirty=None`` for a
    full rewrite — required after structural maintenance or when the
    journal can no longer say what changed.
    """
    gendir = os.path.join(root, f"{CKPT_PREFIX}{generation:08d}")
    tmpdir = os.path.join(root, f"{TMP_PREFIX}{CKPT_PREFIX}{generation:08d}")
    if os.path.exists(gendir):
        raise ValueError(f"checkpoint generation {generation} already exists")
    if os.path.exists(tmpdir):               # debris from an aborted attempt
        shutil.rmtree(tmpdir)
    os.makedirs(tmpdir)
    stats = {"partitions_written": 0, "partitions_linked": 0,
             "link_fallback_copies": 0}

    lvl0 = index.levels[0]
    files: Dict[str, dict] = {}
    part_names: List[str] = []
    prev_files = (prev_manifest or {}).get("files", {})
    prev_parts = (prev_manifest or {}).get("partitions", [])
    for j in range(lvl0.num_partitions):
        if (dirty is not None and j not in dirty and j < len(prev_parts)
                and prev_dir is not None
                and prev_parts[j] in prev_files):
            name = prev_parts[j]
            try:
                os.link(os.path.join(prev_dir, name),
                        os.path.join(tmpdir, name))
                files[name] = dict(prev_files[name])
                part_names.append(name)
                stats["partitions_linked"] += 1
                continue
            except OSError:
                # filesystem without hard links (or the previous blob is
                # gone): fall through and rewrite the partition
                stats["link_fallback_copies"] += 1
        name = f"p{j:06d}-g{generation:08d}.bin"
        data = _part_blob(lvl0, j)
        files[name] = {"crc": _write_blob(os.path.join(tmpdir, name), data),
                       "size": len(data)}
        part_names.append(name)
        stats["partitions_written"] += 1

    # meta blob: per-level centroids; upper-level children arrays are
    # serialized *verbatim* — their in-array order feeds kmeans.assign
    # tie-breaks in _route_to_base, so reordering would break replay
    # determinism.  parent arrays are their exact inverse and are
    # rebuilt at load.
    meta_arrays: List[np.ndarray] = []
    levels_desc: List[dict] = []
    for level in index.levels:
        meta_arrays.append(np.ascontiguousarray(level.centroids,
                                                dtype=np.float32))
        levels_desc.append({"partitions": int(level.num_partitions),
                            "children": level.children is not None})
        if level.children is not None:
            for child in level.children:
                meta_arrays.append(np.asarray(child, dtype=np.int64))
    meta_name = f"meta-g{generation:08d}.bin"
    data = _pack_arrays(*meta_arrays)
    files[meta_name] = {"crc": _write_blob(os.path.join(tmpdir, meta_name),
                                           data),
                        "size": len(data)}

    manifest = {
        "format": CKPT_FORMAT,
        "generation": int(generation),
        "wal_lsn": int(wal_lsn),
        "write_op_count": int(write_op_count),
        "fingerprint": index_state_fingerprint(index).hex(),
        "dim": int(index.dim),
        "max_norm_sq": float(index._max_norm_sq),
        "config": dataclasses.asdict(index.config),
        "levels": levels_desc,
        "meta": meta_name,
        "partitions": part_names,
        "files": files,
    }
    _write_blob(os.path.join(tmpdir, MANIFEST_NAME),
                json.dumps(manifest, sort_keys=True, indent=1).encode())
    _fsync_dir(tmpdir)
    if faults is not None:
        faults.check("ckpt_crash_before_rename")
    os.rename(tmpdir, gendir)
    _fsync_dir(root)
    return manifest, stats


def validate_checkpoint(gendir: str) -> Optional[dict]:
    """Parse and verify one checkpoint directory; returns the manifest on
    success, ``None`` on any damage (unreadable / unparseable manifest,
    missing blob, size or CRC mismatch) — an invalid candidate is
    *rejected*, never raised on, so recovery can fall back to an older
    generation."""
    try:
        with open(os.path.join(gendir, MANIFEST_NAME), "rb") as f:
            manifest = json.loads(f.read().decode("utf-8"))
    except (OSError, ValueError):
        return None
    if not isinstance(manifest, dict) or manifest.get("format") != CKPT_FORMAT:
        return None
    try:
        files = manifest["files"]
        names = list(manifest["partitions"]) + [manifest["meta"]]
        for name in dict.fromkeys(names):
            info = files[name]
            with open(os.path.join(gendir, name), "rb") as f:
                data = f.read()
            if (len(data) != int(info["size"])
                    or zlib.crc32(data) & 0xFFFFFFFF != int(info["crc"])):
                return None
    except (OSError, KeyError, TypeError, ValueError):
        return None
    return manifest


def list_checkpoints(root: str) -> List[Tuple[int, str]]:
    """``(generation, path)`` for every ckpt-* directory, ascending.
    Tmp debris and non-numeric names are ignored."""
    out: List[Tuple[int, str]] = []
    try:
        entries = os.listdir(root)
    except OSError:
        return []
    for name in entries:
        if not name.startswith(CKPT_PREFIX):
            continue
        try:
            gen = int(name[len(CKPT_PREFIX):])
        except ValueError:
            continue
        path = os.path.join(root, name)
        if os.path.isdir(path):
            out.append((gen, path))
    return sorted(out)


def select_checkpoint(root: str) -> Tuple[Optional[str], Optional[dict]]:
    """Newest checkpoint that passes :func:`validate_checkpoint`."""
    for _gen, path in reversed(list_checkpoints(root)):
        manifest = validate_checkpoint(path)
        if manifest is not None:
            return path, manifest
    return None, None


# scan_impl values the JAX package writes, by the port's name for the
# same route (its own "numpy" carries over as it is)
_SCAN_IMPL_NAMES = {"jnp": "torch", "pallas": "cuda"}


def load_checkpoint(gendir: str, manifest: dict,
                    device="cuda") -> QuakeIndex:
    """Materialize a :class:`QuakeIndex` on ``device`` from a validated
    checkpoint.  Derived state is rebuilt deterministically: sqnorms
    from the stored f32 vectors (the same formula insert/build use),
    id_map from the id lists, parent arrays from the verbatim children
    arrays.  The journal and partition stats start fresh — they are
    serving-session state, not logical index state (the fingerprint
    ignores them)."""
    cfg = QuakeConfig(**manifest["config"])
    cfg.scan_impl = _SCAN_IMPL_NAMES.get(cfg.scan_impl, cfg.scan_impl)
    idx = QuakeIndex(int(manifest["dim"]), cfg, device=device)
    n_meta = sum(1 + (d["partitions"] if d["children"] else 0)
                 for d in manifest["levels"])
    with open(os.path.join(gendir, manifest["meta"]), "rb") as f:
        meta = _unpack_arrays(f.read(), n_meta)
    pos = 0
    levels: List[Level] = []
    for d in manifest["levels"]:
        cents = np.ascontiguousarray(meta[pos], dtype=np.float32)
        pos += 1
        if d["children"]:
            children = [np.asarray(meta[pos + j], dtype=np.int64)
                        for j in range(d["partitions"])]
            pos += d["partitions"]
            levels.append(Level(centroids=cents, children=children))
        else:
            levels.append(Level(centroids=cents, vectors=[], ids=[],
                                sqnorms=[]))
    lvl0 = levels[0]
    for name in manifest["partitions"]:
        with open(os.path.join(gendir, name), "rb") as f:
            ids, vecs = _unpack_arrays(f.read(), 2)
        ids = np.asarray(ids, dtype=np.int64)
        vecs = np.ascontiguousarray(vecs, dtype=np.float32)
        lvl0.ids.append(ids)
        lvl0.vectors.append(vecs)
        lvl0.sqnorms.append(np.sum(vecs.astype(np.float64) ** 2, axis=1)
                            .astype(np.float32))
    for l in range(1, len(levels)):
        parent = np.zeros(levels[l - 1].num_partitions, dtype=np.int64)
        for pj, child in enumerate(levels[l].children):
            parent[child] = pj
        levels[l - 1].parent = parent
    idx.levels = levels
    idx._aug_extra = [None] * len(levels)
    idx._max_norm_sq = float(manifest["max_norm_sq"])
    for j, ids in enumerate(lvl0.ids):
        for ext in ids:
            idx.id_map[int(ext)] = j
    return idx


def save_index(index: QuakeIndex, root: str) -> dict:
    """One-shot durable save (``QuakeIndex.save``): a full checkpoint at
    the next free generation, with ``wal_lsn`` set past everything in
    the existing WAL so a subsequent recovery replays nothing on top."""
    os.makedirs(root, exist_ok=True)
    records, _valid, _reason = read_wal(os.path.join(root, WAL_NAME))
    last_lsn = records[-1].lsn if records else 0
    ckpts = list_checkpoints(root)
    next_gen = (ckpts[-1][0] + 1) if ckpts else 1
    _path, prev = select_checkpoint(root)
    if prev is not None:
        last_lsn = max(last_lsn, int(prev["wal_lsn"]))
    manifest, _stats = write_checkpoint(index, root, next_gen,
                                        wal_lsn=last_lsn, write_op_count=0)
    return manifest


# --------------------------------------------------------------------------
# Recovery
# --------------------------------------------------------------------------

class RecoveryError(RuntimeError):
    """No valid checkpoint, or the recovered state failed fingerprint
    verification — damage recovery cannot paper over."""


@dataclass
class RecoveryReport:
    root: str
    generation: int
    ckpt_wal_lsn: int
    wal_last_lsn: int
    wal_reason: str
    wal_truncated_bytes: int
    records_replayed: int
    inserts_replayed: int
    deletes_replayed: int
    fingerprint_checks: int
    write_ops_recovered: int     # cumulative admitted write ops the
                                 # recovered state contains (checkpoint
                                 # count + replayed WAL suffix) — always
                                 # a prefix of the admission order
    fingerprint: str


def recover_index(root: str, verify: bool = True, device="cuda"
                  ) -> Tuple[QuakeIndex, RecoveryReport]:
    """The full recovery path, onto an index on ``device``:

    1. select the newest checkpoint passing CRC + manifest validation
       (damaged generations are skipped, not fatal);
    2. load it and verify ``index_state_fingerprint`` against the
       manifest;
    3. replay the WAL suffix (records with LSN past the checkpoint's),
       verifying any fingerprint records against the replayed state;
    4. truncate the WAL's torn/corrupt tail back to its valid prefix.

    Raises :class:`RecoveryError` when no generation validates or a
    fingerprint check fails.  Torn tails and corrupt records are *not*
    errors — recovery lands on the last valid prefix by design.
    """
    gendir, manifest = select_checkpoint(root)
    if manifest is None:
        raise RecoveryError(f"no valid checkpoint under {root!r}")
    idx = load_checkpoint(gendir, manifest, device=device)
    if verify and index_state_fingerprint(idx).hex() != \
            manifest["fingerprint"]:
        raise RecoveryError(
            f"checkpoint {gendir!r} loaded but its fingerprint does not "
            f"match the manifest — refusing to serve corrupt state")

    wal_path = os.path.join(root, WAL_NAME)
    records, valid, reason = read_wal(wal_path)
    truncated = 0
    if reason not in ("clean", "missing"):
        size = os.path.getsize(wal_path)
        truncated = size - valid
        with open(wal_path, "r+b") as f:
            f.truncate(valid)
            f.flush()
            os.fsync(f.fileno())

    ckpt_lsn = int(manifest["wal_lsn"])
    n_rec = n_ins = n_del = n_fp = 0
    write_ops = int(manifest["write_op_count"])
    for rec in records:
        if rec.lsn <= ckpt_lsn:
            continue
        n_rec += 1
        if rec.rtype == REC_INSERT:
            x, ids = _unpack_arrays(rec.payload, 2)
            idx.insert(np.ascontiguousarray(x, dtype=np.float32),
                       np.asarray(ids, dtype=np.int64))
            n_ins += 1
            write_ops += 1
        elif rec.rtype == REC_DELETE:
            (ids,) = _unpack_arrays(rec.payload, 1)
            idx.delete(np.asarray(ids, dtype=np.int64))
            n_del += 1
            write_ops += 1
        elif rec.rtype == REC_FP:
            n_fp += 1
            if verify and index_state_fingerprint(idx) != rec.payload:
                raise RecoveryError(
                    f"WAL fingerprint record at lsn {rec.lsn} does not "
                    f"match the replayed state")
        # REC_MAINT is informational: a committed maintenance pass is
        # made durable by the forced checkpoint that immediately follows
        # it (DurabilityManager protocol); a crash in between loses the
        # pass — the same rollback semantics as an in-process crash.
    report = RecoveryReport(
        root=root, generation=int(manifest["generation"]),
        ckpt_wal_lsn=ckpt_lsn,
        wal_last_lsn=records[-1].lsn if records else 0,
        wal_reason=reason, wal_truncated_bytes=truncated,
        records_replayed=n_rec, inserts_replayed=n_ins,
        deletes_replayed=n_del, fingerprint_checks=n_fp,
        write_ops_recovered=write_ops,
        fingerprint=index_state_fingerprint(idx).hex())
    return idx, report


# --------------------------------------------------------------------------
# DurabilityManager — the piece ServingRuntime owns
# --------------------------------------------------------------------------

class DurabilityManager:
    """WAL + checkpoint store for one live index.

    Protocol (all calls under the runtime's engine lock):

      * ``log_insert`` / ``log_delete`` *before* the index mutation —
        write-ahead, so a crash mid-append loses the op cleanly (it was
        never applied) and the log order equals the admission order.
      * ``log_maintenance`` + ``checkpoint(force=True)`` immediately
        after a committed maintenance pass: maintenance effects depend
        on served access statistics that are not in the WAL, so they
        are made durable by checkpoint, not by replay.  A crash before
        the checkpoint's rename loses the pass — consistent, because no
        write follows it yet.
      * ``checkpoint()`` every ``ckpt_every_ops`` logged write ops,
        incremental via the journal dirty set.

    Attaching writes a fresh full baseline checkpoint of the live index
    (generation ``prev+1``) with ``wal_lsn`` past everything already in
    the WAL: whatever history the directory holds, recovery from the
    baseline reproduces exactly the state that was attached.
    """

    def __init__(self, index: QuakeIndex, root: str, fsync: str = "batch",
                 wal_batch_ops: int = 32,
                 ckpt_every_ops: Optional[int] = 256,
                 keep_checkpoints: int = 2, faults=None):
        os.makedirs(root, exist_ok=True)
        self.index = index
        self.root = root
        self.faults = faults
        self.ckpt_every_ops = ckpt_every_ops
        self.keep_checkpoints = max(int(keep_checkpoints), 1)
        self.write_op_count = 0          # admitted write ops since attach
        self.ops_since_ckpt = 0
        self.checkpoints_written = 0
        self.checkpoint_failures = 0
        self.partitions_written = 0
        self.partitions_linked = 0
        self.link_fallback_copies = 0
        # seconds spent writing: WAL appends (log_*), checkpoints after
        # attach (cadence and forced), and the attach's baseline
        self.wal_append_s = 0.0
        self.checkpoint_s = 0.0
        self.attach_s = 0.0
        self.generation = 0
        self.last_ckpt_wal_lsn = 0
        self.closed = False
        self._ckpt_journal_version = 0
        self._prev_manifest: Optional[dict] = None
        self._prev_dir: Optional[str] = None
        # fault injection is armed only after attach: the attach baseline
        # models process startup, not a steady-state crash point
        self.wal = WriteAheadLog(os.path.join(root, WAL_NAME), fsync=fsync,
                                 batch_ops=wal_batch_ops, faults=None)
        t0 = time.perf_counter()
        self._attach()
        self.attach_s = time.perf_counter() - t0
        self.wal.faults = faults

    def _attach(self) -> None:
        ckpts = list_checkpoints(self.root)
        prev_gen = ckpts[-1][0] if ckpts else 0
        _path, prev = select_checkpoint(self.root)
        base_lsn = self.wal.last_lsn
        if prev is not None:
            # a crash can truncate the WAL below a manifest's LSN; new
            # appends must never reuse LSNs any manifest already covers
            base_lsn = max(base_lsn, int(prev["wal_lsn"]))
        self.wal.last_lsn = base_lsn
        gen = prev_gen + 1
        manifest, stats = write_checkpoint(
            self.index, self.root, gen, wal_lsn=base_lsn, write_op_count=0)
        self._note_checkpoint(gen, manifest, stats)
        self.wal.append(REC_FP, index_state_fingerprint(self.index))
        self._prune()

    # -- logging (write-ahead; call BEFORE the index mutation) -------------

    def log_insert(self, x: np.ndarray, ids: np.ndarray) -> int:
        t0 = time.perf_counter()
        lsn = self.wal.append(REC_INSERT, _pack_arrays(
            np.ascontiguousarray(x, dtype=np.float32),
            np.asarray(ids, dtype=np.int64)))
        self.wal_append_s += time.perf_counter() - t0
        self.write_op_count += 1
        self.ops_since_ckpt += 1
        return lsn

    def log_delete(self, ids: np.ndarray) -> int:
        t0 = time.perf_counter()
        lsn = self.wal.append(REC_DELETE, _pack_arrays(
            np.asarray(ids, dtype=np.int64)))
        self.wal_append_s += time.perf_counter() - t0
        self.write_op_count += 1
        self.ops_since_ckpt += 1
        return lsn

    def log_maintenance(self, reason: str) -> int:
        t0 = time.perf_counter()
        lsn = self.wal.append(REC_MAINT, reason.encode("utf-8"))
        self.wal_append_s += time.perf_counter() - t0
        return lsn

    # -- checkpointing -----------------------------------------------------

    def checkpoint_due(self) -> bool:
        return (self.ckpt_every_ops is not None
                and self.ops_since_ckpt >= self.ckpt_every_ops)

    def checkpoint(self, force: bool = False) -> bool:
        """Write the next generation (incremental when the journal still
        covers the gap since the previous one).  On success the WAL gets
        a fingerprint record, so a recovery that replays past this point
        re-verifies itself.  Returns False when not due."""
        if self.closed:
            raise RuntimeError("DurabilityManager is closed")
        if not force and not self.checkpoint_due():
            return False
        t0 = time.perf_counter()
        try:
            return self._checkpoint()
        finally:
            self.checkpoint_s += time.perf_counter() - t0

    def _checkpoint(self) -> bool:
        dirty: Optional[Set[int]] = None
        delta = self.index.journal.delta_since(self._ckpt_journal_version)
        if (delta is not None and not delta.structural
                and self._prev_manifest is not None
                and len(self._prev_manifest["partitions"])
                == self.index.levels[0].num_partitions):
            dirty = set(delta.dirty)
        gen = self.generation + 1
        try:
            manifest, stats = write_checkpoint(
                self.index, self.root, gen, wal_lsn=self.wal.last_lsn,
                write_op_count=self.write_op_count, dirty=dirty,
                prev_manifest=self._prev_manifest if dirty is not None
                else None,
                prev_dir=self._prev_dir, faults=self.faults)
        except InjectedFault:
            self.checkpoint_failures += 1
            raise
        self._note_checkpoint(gen, manifest, stats)
        self.wal.append(REC_FP, index_state_fingerprint(self.index))
        self._prune()
        return True

    def _note_checkpoint(self, gen: int, manifest: dict, stats: dict) -> None:
        self.generation = gen
        self._prev_manifest = manifest
        self._prev_dir = os.path.join(self.root, f"{CKPT_PREFIX}{gen:08d}")
        self._ckpt_journal_version = self.index.journal.version
        self.last_ckpt_wal_lsn = int(manifest["wal_lsn"])
        self.ops_since_ckpt = 0
        self.checkpoints_written += 1
        self.partitions_written += stats["partitions_written"]
        self.partitions_linked += stats["partitions_linked"]
        self.link_fallback_copies += stats["link_fallback_copies"]

    def _prune(self) -> None:
        """Drop all but the newest ``keep_checkpoints`` generations.
        Hard-linked blobs stay alive through their inodes, so pruning a
        generation never damages a newer one that links into it."""
        ckpts = list_checkpoints(self.root)
        for _gen, path in ckpts[:-self.keep_checkpoints]:
            shutil.rmtree(path, ignore_errors=True)

    # -- lifecycle / introspection ----------------------------------------

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self.wal.close()

    def simulate_crash(self, keep_unsynced: int = 0) -> int:
        """Kill the process model: close nothing cleanly, truncate the
        WAL to what a real crash would leave (see
        :meth:`WriteAheadLog.simulate_crash`)."""
        self.closed = True
        return self.wal.simulate_crash(keep_unsynced)

    def stats(self) -> dict:
        return {
            "root": self.root,
            "generation": self.generation,
            "write_op_count": self.write_op_count,
            "ops_since_ckpt": self.ops_since_ckpt,
            "last_ckpt_wal_lsn": self.last_ckpt_wal_lsn,
            "checkpoints_written": self.checkpoints_written,
            "checkpoint_failures": self.checkpoint_failures,
            "partitions_written": self.partitions_written,
            "partitions_linked": self.partitions_linked,
            "link_fallback_copies": self.link_fallback_copies,
            "wal_append_s": self.wal_append_s,
            "checkpoint_s": self.checkpoint_s,
            "attach_s": self.attach_s,
            "wal_appends": self.wal.appends,
            "wal_last_lsn": self.wal.last_lsn,
            "wal_bytes_written": self.wal.bytes_written,
            "wal_fsyncs": self.wal.fsyncs,
            "wal_fsyncs_dropped": self.wal.fsyncs_dropped,
            "wal_unsynced_bytes": self.wal.unsynced_bytes,
            "wal_truncated_on_open": self.wal.truncated_on_open,
        }
