"""Crash-safe streaming serving sessions (the port of
``repro/serving/session.py``).

Live traffic is many concurrent audio *streams*, each growing a few
hundred milliseconds at a time and each wanting an updated i-vector per
chunk. Baum-Welch sufficient statistics are additive over frames, so a
per-stream ``(n, f)`` accumulator updated chunk by chunk through the
engine's `chunk_body` holds exactly the statistics of the whole utterance
so far, and the i-vector is re-solved from those statistics without
touching earlier audio again.

  * **SessionStore**: per-stream `StreamSession` accumulators with masked
    chunk updates (`engine.session_stats`), incremental i-vector emission,
    TTL expiry and LRU eviction under a hard accumulator-memory budget,
    and the batch extractor's fused -> sparse -> dense demotion ladder;
  * **SessionJournal**: a write-ahead log of post-update session states in
    the JAX package's ``IVSJ1`` format, byte for byte, so a journal either
    package wrote replays in the other. Every record is length-framed and
    sha256-sealed; replay stops at a torn tail (a crash mid-append) and
    compaction rewrites the log atomically (tmp file + fsync + rename).

Bit-exactness contract, as in the JAX package: accumulators are float32
numpy on the host, added in chunk-arrival order, and the journal records
those bytes. Each chunk's statistics come off the device in one copy and
each solve sends the accumulators back, so a restored session's next
i-vector is bitwise an uninterrupted run's on the same device.

Model rollout (serving/rollout.py): the accumulators are model-independent
until the solve; a hot-swap migrates sessions (re-points them at the new
bundle) or drains them (they stay pinned to the bundle that opened them).
The per-session ``binding`` carries that pin.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import tempfile
import time
from collections import OrderedDict
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import backend as BK
from repro_torch.core import engine as EN
from repro_torch.core import stats as ST
from repro_torch.core import tvm as TV
from repro_torch.serving.extractor import (IVectorExtractor, bucket_cap,
                                           bucket_for)

_MAGIC = b"IVSJ1"          # journal format magic + version
_SHA_LEN = 64              # ascii hex sha256
_LEN = struct.Struct(">I")


@dataclass(frozen=True)
class SessionConfig:
    """Knobs of the streaming session store."""
    chunk_min_bucket: int = 64     # smallest padded chunk shape
    chunk_max_bucket: int = 2048   # cap; longer chunks are truncated to
    #                                the largest power-of-two bucket <= cap
    ttl_s: float = 600.0           # evict sessions idle longer than this
    max_bytes: int = 64 << 20      # hard budget for accumulator memory;
    #                                LRU sessions are evicted beyond it
    length_norm: bool = True
    journal_dir: Optional[str] = None   # None = no write-ahead journal
    journal_compact_bytes: int = 16 << 20  # compact the WAL beyond this
    fsync: bool = False            # per-append fsync: survives power loss,
    #                                not just process death (kill -9 keeps
    #                                OS-buffered writes)


@dataclass
class StreamSession:
    """One live audio stream's accumulated state (additive over chunks)."""
    sid: str
    n: np.ndarray                 # [C] float32 occupancies so far
    f: np.ndarray                 # [C, D] float32 first-order stats so far
    binding: "_Binding"           # the bundle this session is pinned to
    created: float
    last_seen: float
    seq: int = 0                  # journal sequence (== chunks applied)
    chunks: int = 0
    frames: float = 0.0
    loglik: float = 0.0


@dataclass
class ChunkInfo:
    """Per-chunk validation/processing outcome (never silent)."""
    sid: str = ""
    seq: int = 0
    n_frames: int = 0
    bucket: int = 0
    truncated: bool = False
    empty: bool = False
    nonfinite_frames: int = 0
    first_chunk: bool = False


# ---------------------------------------------------------------------------
# Write-ahead journal
# ---------------------------------------------------------------------------


class SessionJournal:
    """Append-only, per-record sha256-sealed session WAL.

    Record framing: ``len(payload) [4B BE] | payload | sha256hex [64B]``.
    Payload: one JSON meta line (keys sorted) + (for 'update' records) the
    raw float32 bytes of n and f. Replay verifies every seal and stops at
    the first violation: a crash mid-append leaves a torn tail, never a
    corrupt restore. Reopening for append truncates the torn tail first,
    so post-crash appends never extend garbage. `compact` rewrites the log
    with one record per live session via tmp file + atomic rename.
    """

    def __init__(self, path: Path, C: int, D: int):
        self.path = Path(path)
        self.C, self.D = int(C), int(D)
        self._fh = None
        self.bytes = 0
        self.records = 0
        self.torn_tail = False   # a torn tail was found (and dropped)

    # -- framing ------------------------------------------------------------

    @staticmethod
    def _frame(payload: bytes) -> bytes:
        return (_LEN.pack(len(payload)) + payload
                + hashlib.sha256(payload).hexdigest().encode())

    def _encode(self, rec: Dict) -> bytes:
        meta = {k: v for k, v in rec.items() if k not in ("n", "f")}
        payload = json.dumps(meta, sort_keys=True).encode() + b"\n"
        if rec.get("kind") == "update":
            payload += (np.ascontiguousarray(rec["n"], np.float32).tobytes()
                        + np.ascontiguousarray(rec["f"],
                                               np.float32).tobytes())
        return payload

    def _decode(self, payload: bytes) -> Dict:
        head, _, body = payload.partition(b"\n")
        rec = json.loads(head.decode())
        if rec.get("kind") == "update":
            C, D = self.C, self.D
            n = np.frombuffer(body[:4 * C], np.float32).copy()
            f = np.frombuffer(body[4 * C:4 * C * (1 + D)],
                              np.float32).reshape(C, D).copy()
            if n.shape != (C,) or f.shape != (C, D):
                raise ValueError("journal update record shape mismatch")
            rec["n"], rec["f"] = n, f
        return rec

    # -- open / replay ------------------------------------------------------

    @classmethod
    def open(cls, path, C: int, D: int
             ) -> Tuple["SessionJournal", List[Dict]]:
        """Open (creating if absent) and replay. Returns the journal in
        append mode plus the verified records, oldest first. A torn tail
        is dropped from the file (truncate) and flagged ``torn_tail``; a
        header mismatching (C, D) raises: replaying another model's
        journal into this store would corrupt every session."""
        j = cls(path, C, D)
        records: List[Dict] = []
        if j.path.exists():
            raw = j.path.read_bytes()
            if raw[:len(_MAGIC)] != _MAGIC and raw:
                raise ValueError(f"{j.path}: not a session journal")
            off = len(_MAGIC) if raw else 0
            while off < len(raw):
                if off + _LEN.size > len(raw):
                    j.torn_tail = True
                    break
                (plen,) = _LEN.unpack_from(raw, off)
                end = off + _LEN.size + plen + _SHA_LEN
                if end > len(raw):
                    j.torn_tail = True
                    break
                payload = raw[off + _LEN.size:off + _LEN.size + plen]
                sha = raw[off + _LEN.size + plen:end]
                if hashlib.sha256(payload).hexdigest().encode() != sha:
                    j.torn_tail = True
                    break
                try:
                    rec = j._decode(payload)
                except (ValueError, AttributeError):
                    j.torn_tail = True
                    break
                if rec.get("kind") == "header":
                    if (rec.get("C"), rec.get("D")) != (j.C, j.D):
                        raise ValueError(
                            f"{j.path}: journal header (C={rec.get('C')}, "
                            f"D={rec.get('D')}) does not match the serving "
                            f"model (C={j.C}, D={j.D})")
                else:
                    records.append(rec)
                off = end
                j.records += 1
            valid_end = off if raw else 0
            if j.torn_tail:
                with open(j.path, "r+b") as fh:
                    fh.truncate(valid_end)
        j.path.parent.mkdir(parents=True, exist_ok=True)
        j._fh = open(j.path, "ab")
        if j._fh.tell() == 0:
            j._fh.write(_MAGIC)
            j.append({"kind": "header", "version": 1, "C": j.C, "D": j.D})
        j.bytes = j._fh.tell()
        return j, records

    # -- append / compact ---------------------------------------------------

    def append(self, rec: Dict, fsync: bool = False):
        buf = self._frame(self._encode(rec))
        self._fh.write(buf)
        self._fh.flush()          # survives process death (kill -9)
        if fsync:
            os.fsync(self._fh.fileno())   # survives power loss too
        self.bytes = self._fh.tell()
        self.records += 1

    def compact(self, records: List[Dict]):
        """Atomically rewrite the WAL as header + one record per live
        session (tmp file + fsync + rename: a crash mid-compaction leaves
        the old log intact, never a half-written one)."""
        fd, tmp = tempfile.mkstemp(dir=self.path.parent,
                                   prefix=".tmp_wal_")
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(_MAGIC)
                fh.write(self._frame(self._encode(
                    {"kind": "header", "version": 1,
                     "C": self.C, "D": self.D})))
                for rec in records:
                    fh.write(self._frame(self._encode(rec)))
                fh.flush()
                os.fsync(fh.fileno())
            self._fh.close()
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._fh = open(self.path, "ab")
        self.bytes = self._fh.tell()
        self.records = 1 + len(records)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# ---------------------------------------------------------------------------
# Per-bundle serving context (the rollout pin)
# ---------------------------------------------------------------------------


class _Binding:
    """Everything session math needs from one bundle: the extractor's
    cached pack and precompute, the store's chunk and solve callables on
    the extractor's device, and the rescore demotion state. Sessions hold
    a reference; `serving/rollout.py` swaps which binding is live."""

    def __init__(self, extractor: IVectorExtractor):
        self.ex = extractor
        self.cfg = extractor.cfg
        self.spec = extractor._spec
        self.pack = extractor._pack
        self.model = extractor.model
        self.tv_pre = extractor._tv_pre
        self.mode: str = extractor.mode
        self.chunk_fns: Dict[str, Callable] = {}
        self.solve_fn: Optional[Callable] = None
        self.sessions = 0


# ---------------------------------------------------------------------------
# The session store
# ---------------------------------------------------------------------------


class SessionStore:
    """Per-stream sufficient-stats accumulators with incremental i-vector
    emission, eviction, and crash-safe journaling.

    >>> store = SessionStore(extractor, SessionConfig(journal_dir=d))
    >>> iv, info = store.update("stream-7", chunk_frames)   # every chunk
    ...                                                     # crash; then:
    >>> store = SessionStore(extractor, SessionConfig(journal_dir=d))
    >>> # every live session restored bit-exact from the journal

    Constructing the store with a ``journal_dir`` that already holds a WAL
    *is* crash recovery: replay rebuilds every journaled session (a torn
    tail is skipped and counted in ``stats['journal_torn']``). The math
    runs on the extractor's device.
    """

    def __init__(self, extractor: IVectorExtractor,
                 cfg: SessionConfig = SessionConfig(),
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self._clock = clock
        self._live = _Binding(extractor)
        self._sessions: "OrderedDict[str, StreamSession]" = OrderedDict()
        self._chaos_fail_modes: set = set()
        C, D = extractor.ubm.means.shape
        self.C, self.D = int(C), int(D)
        self._cap = bucket_cap(cfg.chunk_min_bucket, cfg.chunk_max_bucket)
        # hard accumulator-memory budget -> max live sessions (each costs
        # the f32 bytes of its n [C] + f [C, D])
        self.session_bytes = 4 * (self.C + self.C * self.D)
        self.max_sessions = max(1, int(cfg.max_bytes // self.session_bytes))
        self.stats = {"sessions_open": 0, "sessions_opened": 0,
                      "sessions_closed": 0, "chunks": 0, "emissions": 0,
                      "evicted_ttl": 0, "evicted_lru": 0,
                      "truncated": 0, "empty_chunks": 0,
                      "nonfinite_frames": 0, "degradations": 0,
                      "restored": 0, "journal_torn": 0,
                      "journal_records": 0, "journal_bytes": 0,
                      "compactions": 0, "drained_bundles": 0}
        self._journal: Optional[SessionJournal] = None
        if cfg.journal_dir is not None:
            self._journal, records = SessionJournal.open(
                Path(cfg.journal_dir) / "wal.log", self.C, self.D)
            if self._journal.torn_tail:
                self.stats["journal_torn"] += 1
            self._restore(records)
            self._journal_stats()

    # -- recovery -----------------------------------------------------------

    def _restore(self, records: List[Dict]):
        """Rebuild sessions from replayed WAL records: the newest 'update'
        per sid wins; a 'close' tombstone drops the sid (closed or evicted
        sessions never resurrect). State is the journaled bytes, so the
        restore is bit-exact by construction."""
        now = self._clock()
        alive: "OrderedDict[str, Dict]" = OrderedDict()
        for rec in records:
            if rec.get("kind") == "update":
                alive.pop(rec["sid"], None)     # refresh LRU position
                alive[rec["sid"]] = rec
            elif rec.get("kind") == "close":
                alive.pop(rec["sid"], None)
        for sid, rec in alive.items():
            s = StreamSession(
                sid=sid, n=rec["n"], f=rec["f"], binding=self._live,
                created=float(rec.get("created", now)), last_seen=now,
                seq=int(rec.get("seq", 0)), chunks=int(rec.get("chunks", 0)),
                frames=float(rec.get("frames", 0.0)),
                loglik=float(rec.get("loglik", 0.0)))
            self._sessions[sid] = s
            self._live.sessions += 1
            self.stats["restored"] += 1
        self.stats["sessions_open"] = len(self._sessions)
        self._evict_over_budget()

    # -- journaling ---------------------------------------------------------

    def _record(self, s: StreamSession) -> Dict:
        return {"kind": "update", "sid": s.sid, "seq": s.seq,
                "chunks": s.chunks, "frames": s.frames,
                "loglik": s.loglik, "created": s.created,
                "n": s.n, "f": s.f}

    def _journal_stats(self):
        if self._journal is not None:
            self.stats["journal_records"] = self._journal.records
            self.stats["journal_bytes"] = self._journal.bytes

    def _journal_append(self, rec: Dict):
        if self._journal is None:
            return
        self._journal.append(rec, fsync=self.cfg.fsync)
        # the reference's rule: the threshold is compared with the log's
        # size after the append, so a live set larger than it compacts on
        # every append
        if self._journal.bytes > self.cfg.journal_compact_bytes:
            self.compact()
        self._journal_stats()

    def compact(self):
        """Rewrite the WAL with one record per live session (atomic)."""
        if self._journal is None:
            return
        self._journal.compact([self._record(s)
                               for s in self._sessions.values()])
        self.stats["compactions"] += 1
        self._journal_stats()

    # -- lifecycle ----------------------------------------------------------

    def _open(self, sid: str, now: float) -> StreamSession:
        s = StreamSession(
            sid=sid, n=np.zeros((self.C,), np.float32),
            f=np.zeros((self.C, self.D), np.float32),
            binding=self._live, created=now, last_seen=now)
        self._sessions[sid] = s
        self._live.sessions += 1
        self.stats["sessions_opened"] += 1
        self.stats["sessions_open"] = len(self._sessions)
        return s

    def _drop(self, s: StreamSession, tombstone: bool = True):
        self._sessions.pop(s.sid, None)
        s.binding.sessions -= 1
        if s.binding is not self._live and s.binding.sessions == 0:
            # the last session pinned to a drained-out bundle: release it
            self.stats["drained_bundles"] += 1
        if tombstone:
            self._journal_append({"kind": "close", "sid": s.sid})
        self.stats["sessions_open"] = len(self._sessions)

    def close(self, sid: str) -> Optional[np.ndarray]:
        """Final emission + tombstone; the stream is done."""
        s = self._sessions.get(sid)
        if s is None:
            return None
        iv = self.solve(sid)
        self._drop(s)
        self.stats["sessions_closed"] += 1
        return iv

    def sweep(self, now: Optional[float] = None) -> int:
        """TTL eviction: drop sessions idle longer than ``ttl_s``."""
        now = self._clock() if now is None else now
        expired = [s for s in self._sessions.values()
                   if now - s.last_seen > self.cfg.ttl_s]
        for s in expired:
            self._drop(s)
            self.stats["evicted_ttl"] += 1
        return len(expired)

    def _evict_over_budget(self):
        while len(self._sessions) > self.max_sessions:
            _, s = next(iter(self._sessions.items()))   # LRU head
            self._drop(s)
            self.stats["evicted_lru"] += 1

    # -- chunk validation ---------------------------------------------------

    def _validate(self, chunk) -> Tuple[np.ndarray, np.ndarray, ChunkInfo]:
        u = np.asarray(chunk, np.float32)
        if u.ndim != 2 or u.shape[1] != self.D:
            raise ValueError(f"chunk must be [F, {self.D}], got {u.shape}")
        info = ChunkInfo(n_frames=int(u.shape[0]))
        if u.shape[0] > self._cap:
            u = u[:self._cap]
            info.truncated = True
            info.n_frames = int(u.shape[0])
            self.stats["truncated"] += 1
        valid = np.isfinite(u).all(axis=1)
        bad = int(u.shape[0] - valid.sum())
        if bad:
            info.nonfinite_frames = bad
            self.stats["nonfinite_frames"] += bad
            u = np.where(valid[:, None], u, 0.0).astype(np.float32)
        if valid.sum() == 0:
            info.empty = True
            self.stats["empty_chunks"] += 1
        info.bucket = bucket_for(max(int(u.shape[0]), 1),
                                 self.cfg.chunk_min_bucket, self._cap)
        return u, valid, info

    # -- the chunk / solve callables ----------------------------------------

    def _make_chunk_fn(self, b: _Binding, mode: str) -> Callable:
        """[B, D] frames + [B] mask on the binding's device -> the chunk's
        (n [C], f [C, D], loglik, frames) as float32 numpy, off the device
        in one copy."""
        spec = replace(b.spec, rescore=mode)
        C, D = self.C, self.D

        def fn(pack, feats, mask):
            n, f, ll, fr = EN.session_stats(spec, pack, feats, mask)
            flat = torch.cat([n, f.reshape(-1), ll.reshape(1),
                              fr.reshape(1)]).cpu().numpy()
            return (flat[:C], flat[C:C * (1 + D)].reshape(C, D),
                    flat[-2], flat[-1])

        return fn

    def _run_chunk(self, b: _Binding, feats, mask):
        """One chunk through the engine at the binding's current mode,
        demoting down the rescore ladder on kernel failure instead of
        raising (the batch extractor's contract)."""
        while True:
            mode = b.mode
            try:
                if mode in self._chaos_fail_modes:
                    raise RuntimeError(
                        f"injected {mode}-kernel failure (chaos)")
                if mode not in b.chunk_fns:
                    b.chunk_fns[mode] = self._make_chunk_fn(b, mode)
                dev = b.ex.device
                return b.chunk_fns[mode](b.pack, torch.from_numpy(feats)
                                         .to(dev), torch.from_numpy(mask)
                                         .to(dev))
            except Exception:
                nxt = EN.degrade_rescore(mode)
                if nxt is None:
                    raise
                b.mode = nxt
                self.stats["degradations"] += 1

    def _make_solve_fn(self, b: _Binding) -> Callable:
        """(model, precompute, n [1, C], f [1, C, D]) -> [1, R] i-vector
        as numpy: the extractor's solve on the binding's device."""
        length_norm = self.cfg.length_norm
        standard = b.model.formulation == "standard"
        estep_dtype = b.cfg.estep_dtype
        dev = b.ex.device

        def fn(model, tv_pre, n, f):
            n = torch.from_numpy(n).to(dev)
            f = torch.from_numpy(f).to(dev)
            if standard:
                st = ST.center(ST.BWStats(n, f, None), model.means)
                n, f = st.n, st.f
            iv = TV.extract_ivectors(model, tv_pre, n, f,
                                     estep_dtype=estep_dtype)
            if length_norm:
                iv = BK.length_norm(iv)
            return iv.cpu().numpy()

        return fn

    # -- public API ---------------------------------------------------------

    def update(self, sid: str, chunk, emit: bool = True
               ) -> Tuple[Optional[np.ndarray], ChunkInfo]:
        """Apply one audio chunk to stream ``sid`` (opened on first use):
        align through the engine's chunk body (padded and masked to a
        power-of-two bucket, which is exactly inert), add the chunk's
        (n, f) to the session accumulators, journal the post-update state,
        and (with ``emit``) solve the refined i-vector. Returns
        (i-vector [R] | None, ChunkInfo)."""
        now = self._clock()
        self.sweep(now)
        s = self._sessions.get(sid)
        first = s is None
        if first:
            s = self._open(sid, now)
        b = s.binding
        u, valid, info = self._validate(chunk)
        info.sid, info.first_chunk = sid, first
        B = info.bucket
        feats = np.zeros((B, self.D), np.float32)
        mask = np.zeros((B,), np.float32)
        feats[:u.shape[0]] = u
        mask[:u.shape[0]] = valid.astype(np.float32)
        n, f, ll, fr = self._run_chunk(b, feats, mask)
        # float32 host accumulation in chunk-arrival order: the exact
        # association the journal snapshots and a restart replays
        s.n += n
        s.f += f
        s.frames += float(fr)
        s.loglik += float(ll)
        s.chunks += 1
        s.seq += 1
        info.seq = s.seq
        s.last_seen = now
        self._sessions.move_to_end(sid)
        self.stats["chunks"] += 1
        self._journal_append(self._record(s))
        self._evict_over_budget()
        iv = self.solve(sid) if emit else None
        return iv, info

    def solve(self, sid: str) -> np.ndarray:
        """Current i-vector of stream ``sid`` from its accumulated
        statistics (no new audio)."""
        s = self._sessions[sid]
        b = s.binding
        if b.solve_fn is None:
            b.solve_fn = self._make_solve_fn(b)
        iv = b.solve_fn(b.model, b.tv_pre, s.n[None], s.f[None])
        self.stats["emissions"] += 1
        return iv[0]

    def session(self, sid: str) -> Optional[StreamSession]:
        return self._sessions.get(sid)

    def __len__(self) -> int:
        return len(self._sessions)

    def __contains__(self, sid: str) -> bool:
        return sid in self._sessions

    # -- rollout integration ------------------------------------------------

    def rebind(self, extractor: IVectorExtractor,
               policy: str = "migrate") -> Dict[str, int]:
        """Point the store at a new bundle (serving/rollout.py).

        ``policy='migrate'``: every live session re-points at the new
        bundle, keeping its accumulated (n, f) (additive statistics are
        model-independent until the solve), so only future chunks and
        solves use the new model. ``'drain'``: live sessions stay pinned
        to the bundle that opened them until they close or evict; only
        new sessions bind to the new bundle."""
        if policy not in ("migrate", "drain"):
            raise ValueError(f"policy must be 'migrate'|'drain': {policy!r}")
        new = _Binding(extractor)
        self._live = new
        moved = 0
        if policy == "migrate":
            # every live session moves, including ones still draining from
            # an earlier swap (a rollback must leave nothing pinned to an
            # intermediate bundle)
            for s in self._sessions.values():
                if s.binding is not new:
                    s.binding.sessions -= 1
                    s.binding = new
                    new.sessions += 1
                    moved += 1
        return {"migrated": moved, "pinned_to_old": self.draining()}

    def draining(self) -> int:
        """Sessions still pinned to a non-live (draining) bundle."""
        return sum(1 for s in self._sessions.values()
                   if s.binding is not self._live)

    # -- observability ------------------------------------------------------

    def health(self) -> Dict:
        """Store-level readiness payload (mirrors the extractor's)."""
        self._journal_stats()
        return {"sessions_open": len(self._sessions),
                "max_sessions": self.max_sessions,
                "session_bytes": self.session_bytes,
                "budget_bytes": int(self.cfg.max_bytes),
                "used_bytes": len(self._sessions) * self.session_bytes,
                "draining": self.draining(),
                "mode": self._live.mode,
                "journal": None if self._journal is None else {
                    "path": str(self._journal.path),
                    "bytes": self._journal.bytes,
                    "records": self._journal.records,
                    "torn_recovered": self.stats["journal_torn"],
                    "compactions": self.stats["compactions"]},
                "stats": dict(self.stats)}

    def close_store(self):
        if self._journal is not None:
            self._journal.close()
