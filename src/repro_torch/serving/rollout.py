"""Zero-downtime bundle rollout for the serving path (the port of
``repro/serving/rollout.py``).

The swap is a gated state machine, not an assignment:

    shadow-load -> canary -> shadow parity -> SWAP -> post-swap probe
         |            |            |                        |
       reject       reject       reject              auto-ROLLBACK

  * **shadow-load**: the candidate `Bundle` is loaded and integrity-
    verified (api/bundle.py content_hash) into its own `IVectorExtractor`
    on the live extractor's device, while the live one keeps serving; a
    corrupt or schema-incompatible bundle is rejected before it sees
    traffic;
  * **canary**: the candidate runs the extractor's `health_check` probe
    (the path real traffic takes, demotion ladder included);
  * **shadow parity**: operator-supplied utterances are scored by both
    extractors: the candidate must give finite, non-zero i-vectors; when
    the two bundles hash identically the outputs must be bit-exact, and
    an optional ``max_cos_dist`` bounds how far a new model may move the
    embedding space;
  * **swap**: one reference assignment. Live streaming sessions are
    *migrated* (re-pointed at the new bundle; their (n, f) are
    model-independent until the solve) or *drained* (pinned to the old
    bundle until they close);
  * **rollback**: the old extractor object is retained with its cached
    precompute, so ``rollback()`` restores the previous serving state
    bit-exact (it is the previous state, not a reload). A failed
    post-swap probe triggers it automatically.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.api import bundle as BND
from repro_torch.serving.extractor import IVectorExtractor


@dataclass
class RolloutReport:
    """What happened to one candidate bundle, stage by stage."""
    outcome: str                   # "rejected" | "swapped" | "rolled_back"
    reason: str = ""
    path: str = ""
    candidate_hash: str = ""
    live_hash: str = ""
    policy: str = "migrate"
    canary: Optional[Dict] = None          # candidate health_check payload
    parity: Optional[Dict] = None          # shadow-scoring gate outcome
    post_swap: Optional[Dict] = None       # live probe after the swap
    sessions: Optional[Dict] = None        # migrate/drain counts
    elapsed_s: float = 0.0


def _model_hash(ex: IVectorExtractor) -> str:
    """Content identity of what an extractor serves (the bundle hash of
    the same arrays; device tensors are copied to the host to hash)."""
    return BND.content_hash({"ubm": ex.ubm, "model": ex.model})


class RolloutController:
    """Owns which extractor is live and runs the gated swap.

    >>> rc = RolloutController(live_extractor, store=session_store)
    >>> report = rc.roll(candidate_path, shadow_utts=recent_traffic)
    >>> report.outcome   # "swapped" | "rejected" | "rolled_back"
    """

    def __init__(self, live: IVectorExtractor, store=None, queue=None,
                 clock=time.perf_counter):
        self.live = live
        self.store = store          # serving.session.SessionStore | None
        self.queue = queue          # serving.guard.AdmissionQueue | None
        self.prev: Optional[IVectorExtractor] = None
        self._clock = clock
        self.history: List[RolloutReport] = []

    # -- stages -------------------------------------------------------------

    def shadow_load(self, path) -> IVectorExtractor:
        """Load + integrity-verify the candidate into its own extractor on
        the live extractor's device (raises on corruption or a schema
        mismatch: the first gate)."""
        return IVectorExtractor.from_bundle(path, serving=self.live.serving,
                                            device=self.live.device)

    def shadow_gate(self, cand: IVectorExtractor,
                    utterances: Sequence,
                    max_cos_dist: Optional[float] = None) -> Dict:
        """Score ``utterances`` through both extractors and gate.

        Always required: candidate outputs finite with non-zero norm.
        Identical content hashes additionally require bit-exact outputs;
        ``max_cos_dist`` (0 = identical, 2 = opposite) optionally bounds
        embedding drift for new models."""
        same = _model_hash(cand) == _model_hash(self.live)
        out = {"ok": True, "n_utterances": len(utterances),
               "same_content": same, "bit_exact": None,
               "max_cos_dist": None, "reason": ""}
        if not utterances:
            return out
        live_iv = self.live.extract(utterances)
        cand_iv = cand.extract(utterances)
        if not np.isfinite(cand_iv).all():
            out.update(ok=False,
                       reason="candidate produced non-finite i-vectors")
            return out
        norms = np.linalg.norm(cand_iv, axis=1)
        if not (norms > 0).all():
            out.update(ok=False,
                       reason="candidate produced zero i-vectors")
            return out
        if same:
            out["bit_exact"] = bool(np.array_equal(live_iv, cand_iv))
            if not out["bit_exact"]:
                out.update(ok=False, reason=(
                    "bundles share a content hash but shadow outputs "
                    "differ — serving-path mismatch"))
                return out
        ln = np.linalg.norm(live_iv, axis=1)
        cos = np.sum(live_iv * cand_iv, axis=1) / np.maximum(
            ln * norms, np.finfo(np.float32).tiny)
        out["max_cos_dist"] = float(np.max(1.0 - cos))
        if max_cos_dist is not None and out["max_cos_dist"] > max_cos_dist:
            out.update(ok=False, reason=(
                f"shadow drift {out['max_cos_dist']:.4f} exceeds "
                f"max_cos_dist={max_cos_dist}"))
        return out

    def swap(self, cand: IVectorExtractor,
             policy: str = "migrate") -> Dict:
        """The cutover: one reference assignment; the previous extractor
        is retained for rollback. Live sessions migrate or drain per
        ``policy``."""
        self.prev = self.live
        self.live = cand
        counts: Dict = {}
        if self.store is not None:
            counts = self.store.rebind(cand, policy=policy)
        if self.queue is not None:
            self.queue.extractor = cand
        return counts

    def rollback(self) -> bool:
        """Restore the previous extractor bit-exact (the same object, its
        cached precompute included). Sessions migrate back. Returns False
        if there is nothing to roll back to."""
        if self.prev is None:
            return False
        self.live = self.prev
        self.prev = None
        if self.store is not None:
            self.store.rebind(self.live, policy="migrate")
        if self.queue is not None:
            self.queue.extractor = self.live
        return True

    # -- the one-shot gated rollout -----------------------------------------

    def roll(self, path, shadow_utts: Sequence = (),
             policy: str = "migrate",
             max_cos_dist: Optional[float] = None) -> RolloutReport:
        """shadow-load -> canary -> parity -> swap -> post-swap probe,
        rejecting before the swap and rolling back after it. The live
        extractor serves through every pre-swap stage."""
        t0 = self._clock()
        rep = RolloutReport(outcome="rejected", path=str(path),
                            policy=policy, live_hash=_model_hash(self.live))
        try:
            cand = self.shadow_load(path)
        except Exception as e:   # any load failure rejects the candidate
            rep.reason = f"shadow-load failed: {e!r}"
            rep.elapsed_s = self._clock() - t0
            self.history.append(rep)
            return rep
        rep.candidate_hash = _model_hash(cand)
        rep.canary = cand.health_check()
        if not rep.canary["ok"]:
            rep.reason = f"canary failed: {rep.canary.get('error')}"
            rep.elapsed_s = self._clock() - t0
            self.history.append(rep)
            return rep
        rep.parity = self.shadow_gate(cand, shadow_utts,
                                      max_cos_dist=max_cos_dist)
        if not rep.parity["ok"]:
            rep.reason = f"shadow gate failed: {rep.parity['reason']}"
            rep.elapsed_s = self._clock() - t0
            self.history.append(rep)
            return rep
        rep.sessions = self.swap(cand, policy=policy)
        rep.post_swap = self.live.health_check()
        if rep.post_swap["ok"]:
            rep.outcome = "swapped"
        else:
            self.rollback()
            rep.outcome = "rolled_back"
            rep.reason = (f"post-swap probe failed: "
                          f"{rep.post_swap.get('error')}")
        rep.elapsed_s = self._clock() - t0
        self.history.append(rep)
        return rep
