"""Admission control for the serving session (the port of
``repro/serving/guard.py``): a bounded queue with per-request deadlines,
explicit load-shedding, and adaptive micro-batch sizing.

  * **bounded queue**: ``submit`` on a full queue raises `QueueFull`
    at once (the caller's 503/retry-after) instead of buffering work the
    session can never catch up on;
  * **per-request deadlines**: ``drain`` sheds requests that expired while
    queued, with no device work, and batches the live ones through
    `IVectorExtractor.extract`;
  * **first-response priority**: a full queue sheds the ``refine`` chunk
    with the slackest deadline to admit a ``first`` chunk (a user waiting
    for a first i-vector); a ``refine`` on a full queue is shed outright;
  * **adaptive micro-batching**: ``batch_budget`` grows the per-drain
    batch with queue depth, in power-of-two steps up to the extractor's
    ``max_batch``;
  * **observability**: every shed request is counted by cause
    (``shed_full`` / ``shed_deadline`` / ``shed_refine``) and ``health``
    returns the readiness-probe payload.

The queue is synchronous and single-threaded: the admission policy a
server loop pumps (one ``drain`` per batching tick), with an injectable
clock. A request submitted with a ``sid`` while a store is attached is a
streaming chunk: ``drain`` routes it through ``SessionStore.update``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.serving.extractor import IVectorExtractor


class QueueFull(RuntimeError):
    """The admission queue is at capacity; the request was load-shed
    before any work happened (the caller should back off and retry)."""


@dataclass
class _Pending:
    id: int
    utterance: np.ndarray
    deadline: float          # absolute, in the queue's clock
    submitted: float
    kind: str = "first"      # "first" | "refine" (shedding priority)
    sid: Optional[str] = None   # streaming session id (store routing)


@dataclass
class RequestResult:
    """Outcome of one admitted request after a ``drain``."""
    id: int
    ivector: Optional[np.ndarray]   # None when expired/preempted
    expired: bool
    wait_s: float                   # time spent queued
    info: Optional[object] = None   # RequestInfo | session ChunkInfo
    kind: str = "first"
    sid: Optional[str] = None
    preempted: bool = False         # shed to admit a first-response


@dataclass
class AdmissionQueue:
    """Bounded deadline-aware work queue in front of one extractor (and,
    optionally, one streaming `SessionStore`)."""
    extractor: IVectorExtractor
    max_pending: int = 64
    default_timeout: float = 30.0
    clock: Callable[[], float] = time.monotonic
    min_batch: int = 1              # adaptive batch floor (near-idle)
    store: Optional[object] = None  # serving.session.SessionStore
    _pending: List[_Pending] = field(default_factory=list)
    _preempted: List[_Pending] = field(default_factory=list)
    _next_id: int = 0
    stats: Dict[str, int] = field(default_factory=lambda: {
        "submitted": 0, "shed_full": 0, "shed_deadline": 0,
        "shed_refine": 0, "served": 0})

    def __len__(self) -> int:
        return len(self._pending)

    def submit(self, utterance, timeout: Optional[float] = None,
               kind: str = "first", sid: Optional[str] = None) -> int:
        """Admit one request; returns its id or raises `QueueFull`.

        On a full queue a ``first`` request preempts the queued ``refine``
        with the slackest (latest) deadline: that session keeps its last
        emitted i-vector, the new user gets their first. A ``refine`` on a
        full queue is shed outright."""
        if kind not in ("first", "refine"):
            raise ValueError(f"kind must be 'first'|'refine': {kind!r}")
        if len(self._pending) >= self.max_pending:
            victim = None
            if kind == "first":
                refines = [p for p in self._pending if p.kind == "refine"]
                if refines:
                    victim = max(refines, key=lambda p: p.deadline)
            if victim is None:
                self.stats["shed_full"] += 1
                raise QueueFull(
                    f"admission queue at capacity ({self.max_pending})")
            self._pending.remove(victim)
            self._preempted.append(victim)
            self.stats["shed_refine"] += 1
        now = self.clock()
        rid = self._next_id
        self._next_id += 1
        self._pending.append(_Pending(
            id=rid, utterance=np.asarray(utterance, np.float32),
            deadline=now + (self.default_timeout if timeout is None
                            else timeout),
            submitted=now, kind=kind, sid=sid))
        self.stats["submitted"] += 1
        return rid

    def batch_budget(self) -> int:
        """How many requests the next ``drain`` should serve: grows in
        power-of-two steps with queue depth, from ``min_batch`` up to the
        extractor's ``max_batch``."""
        depth = len(self._pending)
        cap = self.extractor.serving.max_batch
        b = max(1, self.min_batch)
        while b < depth and b < cap:
            b *= 2
        return min(b, cap)

    def drain(self, budget: Optional[int] = None
              ) -> Dict[int, RequestResult]:
        """Serve up to ``budget`` admissible requests (None = all; pass
        ``batch_budget()`` for the adaptive streaming loop). Expired
        requests are shed with no device work; preempted refinements
        surface as shed results. Under a budget, first-response chunks
        are served before refinements and earlier deadlines first; the
        leftovers stay queued for the next tick (and are shed there if
        their deadline passes)."""
        now = self.clock()
        results: Dict[int, RequestResult] = {}
        for p in self._preempted:
            results[p.id] = RequestResult(
                id=p.id, ivector=None, expired=True,
                wait_s=now - p.submitted, kind=p.kind, sid=p.sid,
                preempted=True)
        self._preempted = []
        live: List[_Pending] = []
        for p in self._pending:
            if now > p.deadline:
                self.stats["shed_deadline"] += 1
                results[p.id] = RequestResult(
                    id=p.id, ivector=None, expired=True,
                    wait_s=now - p.submitted, kind=p.kind, sid=p.sid)
            else:
                live.append(p)
        if budget is None:
            serve, self._pending = live, []
        else:
            ranked = sorted(
                live, key=lambda p: (p.kind != "first", p.deadline))
            serve = ranked[:max(0, int(budget))]
            keep = {p.id for p in ranked[max(0, int(budget)):]}
            self._pending = [p for p in live if p.id in keep]
        session = [p for p in serve
                   if p.sid is not None and self.store is not None]
        session_ids = {p.id for p in session}
        batch = [p for p in serve if p.id not in session_ids]
        for p in session:
            iv, cinfo = self.store.update(p.sid, p.utterance)
            results[p.id] = RequestResult(
                id=p.id, ivector=iv, expired=False,
                wait_s=self.clock() - p.submitted, info=cinfo,
                kind=p.kind, sid=p.sid)
            self.stats["served"] += 1
        if batch:
            ivecs, infos = self.extractor.extract(
                [p.utterance for p in batch], return_info=True)
            done = self.clock()
            for p, iv, info in zip(batch, ivecs, infos):
                results[p.id] = RequestResult(
                    id=p.id, ivector=iv, expired=False,
                    wait_s=done - p.submitted, info=info, kind=p.kind)
            self.stats["served"] += len(batch)
        return results

    # -- readiness probe ----------------------------------------------------

    def health(self) -> Dict:
        """The readiness-probe payload: the extractor's canary
        `health_check` plus the admission-control surface (queue depth,
        adaptive batch budget, shed counters, current rescore mode) and
        the session store's state when one is attached."""
        probe = self.extractor.health_check()
        payload = {
            "ok": probe["ok"], "mode": self.extractor.mode,
            "queue": {"depth": len(self._pending),
                      "max_pending": self.max_pending,
                      "batch_budget": self.batch_budget(),
                      "preempted_unreported": len(self._preempted),
                      **dict(self.stats)},
            "extractor": probe,
        }
        if self.store is not None:
            payload["sessions"] = self.store.health()
        return payload
