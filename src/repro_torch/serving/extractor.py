"""Batched variable-length i-vector extraction service (the port of
``repro/serving/extractor.py``).

Production traffic is ragged: one utterance per request, each a different
number of frames. The session

  * **caches the precompute** once: ``engine.pack_ubm`` (full-covariance
    precisions, the diag preselection GMM and the packed rescoring rows)
    and ``tvm.precompute`` (T^T Σ^{-1} T, packed);
  * **buckets** each utterance into the next power-of-two frame count,
    zero-padded with a frame mask, and **micro-batches** requests that
    share a bucket up to ``max_batch`` (the batch is padded with zero-mask
    rows too). Masking makes the padding exact: a padded-and-masked
    utterance gives the same statistics as the unpadded one;
  * **length-norms** the i-vectors.

Guardrails: non-finite frames are masked out and counted, over-long
utterances are truncated with an explicit ``truncated`` flag, empty ones
come back as flagged zero vectors. A runtime failure of the rescoring
kernel demotes the session down ``engine.RESCORE_LADDER`` (sparse ->
dense) and keeps serving; ``health_check`` runs a canary through the same
path as real traffic.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.ivector_tvm import IVectorConfig
from repro_torch.core import backend as BK
from repro_torch.core import engine as EN
from repro_torch.core import stats as ST
from repro_torch.core import tvm as TV
from repro_torch.core import ubm as U


def bucket_cap(min_bucket: int, max_bucket: int) -> int:
    """Largest bucket on the power-of-two grid (min_bucket * 2^k) that
    does not exceed ``max_bucket``: the length long requests are
    truncated to, so that truncation always lands on the bucket grid."""
    cap = max(1, int(min_bucket))
    while cap * 2 <= max_bucket:
        cap *= 2
    return cap


def bucket_for(n_frames: int, min_bucket: int, cap: int) -> int:
    """Smallest power-of-two bucket holding ``n_frames``, capped."""
    b = max(1, int(min_bucket))
    while b < n_frames and b < cap:
        b *= 2
    return min(b, cap)


@dataclass(frozen=True)
class ServingConfig:
    max_batch: int = 16      # micro-batch size
    min_bucket: int = 64     # smallest frame bucket
    max_bucket: int = 8192   # hard cap; longer utterances are truncated to
    #                          the largest power-of-two bucket <= this
    length_norm: bool = True


@dataclass
class RequestInfo:
    """Per-request validation outcome (``extract(..., return_info=True)``);
    the counters in ``IVectorExtractor.stats`` aggregate the same events."""
    n_frames: int = 0          # frames that actually entered extraction
    bucket: int = 0
    truncated: bool = False    # clipped at ServingConfig.max_bucket
    empty: bool = False        # zero valid frames -> zero i-vector
    nonfinite_frames: int = 0  # NaN/Inf frames masked out of the input


class IVectorExtractor:
    """One serving session: cached per-model precompute, bucketed batches.

    >>> ex = IVectorExtractor.from_state(cfg, (model, ubm))
    >>> ivecs = ex.extract(list_of_[F_i, D]_arrays)   # [N, R] length-normed

    The session lives on ``device`` (CUDA unless the caller names one).
    """

    def __init__(self, cfg: IVectorConfig, model: TV.TVModel,
                 ubm: U.FullGMM, serving: ServingConfig = ServingConfig(),
                 device=None):
        if cfg.rescore == "fused":
            # refused, not demoted: a silent fused->sparse demotion would
            # hide that the fused kernel does not exist in the port yet
            raise NotImplementedError(
                "rescore='fused' needs the gmm_align kernel, which the "
                "port brings in its second slice; use 'sparse' or 'dense'")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(self.device)
        self.ubm = ubm.to(self.device)
        self.serving = serving
        self._spec = EN.EngineSpec(
            n_components=cfg.n_components, top_k=cfg.posterior_top_k,
            floor=cfg.posterior_floor, rescore=cfg.rescore)
        self._pack = EN.pack_ubm(self.ubm, self.device)
        self._tv_pre = TV.precompute(self.model, estep=cfg.estep,
                                     device=self.device)
        # the session starts at the config's mode and demotes down
        # engine.RESCORE_LADDER on kernel failure
        self.mode: str = cfg.rescore
        self._cap = bucket_cap(serving.min_bucket, serving.max_bucket)
        # chaos hook (tests): modes whose batch call raises, simulating a
        # kernel failure
        self._chaos_fail_modes: set = set()
        self._seen_buckets: set = set()
        self.stats = {"requests": 0, "batches": 0, "compiles": 0,
                      "real_frames": 0, "padded_frames": 0, "truncated": 0,
                      "empty": 0, "nonfinite_frames": 0,
                      "degradations": 0, "mode": self.mode}

    @classmethod
    def from_state(cls, cfg: IVectorConfig, state,
                   serving: ServingConfig = ServingConfig(),
                   device=None) -> "IVectorExtractor":
        """Session from the port's ``(model, ubm)`` pair."""
        model, ubm = state
        return cls(cfg, model, ubm, serving, device=device)

    # -- bucketing ----------------------------------------------------------

    def bucket_for(self, n_frames: int) -> int:
        return bucket_for(n_frames, self.serving.min_bucket, self._cap)

    def buckets(self) -> List[int]:
        return sorted(self._seen_buckets)

    # -- one batch ----------------------------------------------------------

    def _extract_batch(self, mode: str, feats, mask) -> torch.Tensor:
        """[B, bucket, D], [B, bucket] -> [B, R] for one rescore mode (zero
        rows where the mask is all 0). The align -> stats math is the
        engine's chunk body, and every mode computes the same statistics
        to f32 rounding, so a demotion changes speed, not answers."""
        spec = replace(self._spec, rescore=mode)
        cs = EN.chunk_body(spec, self._pack, feats, mask)
        n_, f_ = cs.n, cs.f
        if self.model.formulation == "standard":
            stc = ST.center(ST.BWStats(n_, f_, None), self.model.means)
            n_, f_ = stc.n, stc.f
        iv = TV.extract_ivectors(self.model, self._tv_pre, n_, f_,
                                 estep_dtype=self.cfg.estep_dtype)
        if self.serving.length_norm:
            iv = BK.length_norm(iv)
        # zero-occupancy padding rows extract the prior mean: blank them
        live = (mask > 0).any(dim=1)[:, None]
        return torch.where(live, iv, torch.zeros((), dtype=iv.dtype,
                                                 device=iv.device))

    def _run_batch(self, feats, mask) -> np.ndarray:
        """One batch at the session's current mode, demoting down the
        rescore ladder on failure instead of raising. Only a failure of
        the reference 'dense' path propagates."""
        while True:
            mode = self.mode
            try:
                if mode in self._chaos_fail_modes:
                    raise RuntimeError(
                        f"injected {mode}-kernel failure (chaos)")
                return self._extract_batch(mode, feats, mask).cpu().numpy()
            except Exception:
                nxt = EN.degrade_rescore(mode)
                if nxt is None:
                    raise
                self.mode = nxt
                self.stats["mode"] = nxt
                self.stats["degradations"] += 1

    # -- input validation ---------------------------------------------------

    def _validate(self, u: np.ndarray, D: int
                  ) -> Tuple[np.ndarray, np.ndarray, RequestInfo]:
        """One raw utterance -> (clean feats, valid-frame flags, info).
        Non-finite frames are zeroed AND masked out, so a poisoned frame
        contributes nothing instead of flooding the batch with NaNs."""
        if u.ndim != 2 or u.shape[1] != D:
            raise ValueError(f"utterance must be [F, {D}], got {u.shape}")
        info = RequestInfo(n_frames=int(u.shape[0]))
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
            self.stats["empty"] += 1
        info.bucket = self.bucket_for(max(int(u.shape[0]), 1))
        return u, valid, info

    # -- public API ---------------------------------------------------------

    def extract(self, utterances: Sequence, return_info: bool = False):
        """Ragged [F_i, D] utterances -> [N, R] i-vectors (input order).
        With ``return_info`` also returns the per-request `RequestInfo`
        list (truncation/empty/non-finite flags)."""
        D = self.ubm.means.shape[1]
        R = self.model.rank
        B = self.serving.max_batch
        utts, valids, infos = [], [], []
        for raw in utterances:
            u, valid, info = self._validate(np.asarray(raw, np.float32), D)
            utts.append(u)
            valids.append(valid)
            infos.append(info)
        groups: Dict[int, List[int]] = {}
        for i, info in enumerate(infos):
            groups.setdefault(info.bucket, []).append(i)
        out = np.zeros((len(utts), R), np.float32)
        for bucket in sorted(groups):
            if bucket not in self._seen_buckets:
                # "compiles" keeps the JAX session's name: one count per
                # bucket shape the session has served
                self._seen_buckets.add(bucket)
                self.stats["compiles"] += 1
            idxs = groups[bucket]
            for s in range(0, len(idxs), B):
                chunk = idxs[s:s + B]
                feats = np.zeros((B, bucket, D), np.float32)
                mask = np.zeros((B, bucket), np.float32)
                for j, i in enumerate(chunk):
                    n = min(utts[i].shape[0], bucket)
                    feats[j, :n] = utts[i][:n]
                    mask[j, :n] = valids[i][:n].astype(np.float32)
                    self.stats["real_frames"] += n
                    self.stats["padded_frames"] += bucket - n
                out[chunk] = self._run_batch(
                    torch.from_numpy(feats).to(self.device),
                    torch.from_numpy(mask).to(self.device))[:len(chunk)]
                self.stats["batches"] += 1
        self.stats["requests"] += len(utts)
        if return_info:
            return out, infos
        return out

    __call__ = extract

    # -- health / readiness -------------------------------------------------

    def health_check(self) -> Dict:
        """Readiness probe: extract a deterministic canary utterance
        through the SAME path as real traffic (validation, bucketing,
        degradation wrapper) and verify the result is finite and
        non-trivial. Does not touch request stats."""
        D = self.ubm.means.shape[1]
        F = self.serving.min_bucket
        canary = np.asarray(
            np.sin(np.arange(F)[:, None] * 0.37
                   + np.arange(D)[None, :] * 1.13), np.float32)
        before = dict(self.stats)
        t0 = time.perf_counter()
        try:
            iv = self.extract([canary])
            latency = time.perf_counter() - t0
            norm = float(np.linalg.norm(iv[0]))
            ok = bool(np.isfinite(iv).all()) and norm > 0.0
            err = None
        except Exception as e:   # dense path failed too: not servable
            latency = time.perf_counter() - t0
            ok, norm, err = False, float("nan"), repr(e)
        # the canary is a probe, not traffic: restore request counters
        # (mode/degradations reflect what the probe learned and stay)
        for k in ("requests", "batches", "real_frames", "padded_frames"):
            self.stats[k] = before[k]
        return {"ok": ok, "mode": self.mode,
                "degradations": self.stats["degradations"],
                "latency_s": latency, "canary_norm": norm,
                "buckets_compiled": len(self._seen_buckets),
                "error": err}
