"""Typed stage artifacts (the port of ``repro/api/artifacts.py``).

Each pipeline stage consumes and produces a small, named artifact:
``UBMArtifact`` (the trained universal background model), ``TVArtifact``
(the total-variability model after EM) and ``BackendArtifact`` (the
scoring chain: centring -> optional whitening -> length-norm -> LDA ->
PLDA). Artifacts carry their own provenance (``meta``), compose into a
versioned ``Bundle`` (api/bundle.py), and are what `IVectorRecipe` threads
between stages. They are plain dataclasses of tensors.

The backend train/apply/score functions here are the one implementation
of the paper's §4.1 evaluation chain; `core.pipeline.evaluate_state` is a
shim over them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.ivector_tvm import IVectorConfig
from repro_torch.core import backend as BK
from repro_torch.core import tvm as TV
from repro_torch.core import ubm as U
from repro_torch.data.speech import make_trials

SCHEMA_VERSION = 1


@dataclass
class UBMArtifact:
    """Stage 'ubm' output: the trained full-covariance UBM."""
    ubm: U.FullGMM
    meta: Dict = field(default_factory=dict)   # seed, n_frames, ...

    @property
    def n_components(self) -> int:
        return self.ubm.n_components


@dataclass
class TVArtifact:
    """Stage 'tvm' output: the trained total-variability model plus the
    (possibly realignment-refreshed) UBM it is aligned against."""
    model: TV.TVModel
    ubm: U.FullGMM
    iterations: int = 0
    meta: Dict = field(default_factory=dict)   # seed, formulation, ...

    @property
    def rank(self) -> int:
        return self.model.rank


@dataclass
class BackendArtifact:
    """Stage 'backend' output: the trained scoring chain.

    ``whitener`` is present only when the extractor skipped minimum
    divergence (paper §4.1: whiten before length-norm in that case).
    """
    mu: torch.Tensor                         # [R] training i-vector mean
    lda: BK.LDA
    plda: BK.PLDA
    whitener: Optional[torch.Tensor] = None  # [R, R] or None
    meta: Dict = field(default_factory=dict)

    def to(self, device) -> "BackendArtifact":
        return BackendArtifact(
            self.mu.to(device), self.lda.to(device), self.plda.to(device),
            None if self.whitener is None else self.whitener.to(device),
            dict(self.meta))


# ---------------------------------------------------------------------------
# Backend training / application (the canonical §4.1 chain)
# ---------------------------------------------------------------------------


def train_backend(cfg: IVectorConfig, ivecs, labels) -> BackendArtifact:
    """Fit the scoring chain on training i-vectors [N, R] (a tensor; the
    artifact lives on its device)."""
    mu = torch.mean(ivecs, dim=0)
    x = ivecs - mu
    W = None
    if not cfg.min_divergence:
        # paper §4.1: whiten before length-norm when min-div was not used
        _, W = BK.whitener(x)
        x = x @ W.T
    x = BK.length_norm(x)
    lda = BK.train_lda(x, labels, min(cfg.lda_dim, x.shape[1]))
    plda = BK.train_plda(BK.apply_lda(lda, x), labels)
    return BackendArtifact(mu=mu, lda=lda, plda=plda, whitener=W,
                           meta={"lda_dim": int(lda.proj.shape[1]),
                                 "whitened": W is not None})


def apply_backend(art: BackendArtifact, ivecs) -> torch.Tensor:
    """Project raw i-vectors [N, R] into PLDA scoring space [N, K]."""
    x = ivecs - art.mu
    if art.whitener is not None:
        x = x @ art.whitener.T
    return BK.apply_lda(art.lda, BK.length_norm(x))


def score_trials(art: BackendArtifact, xl, a, b) -> np.ndarray:
    """PLDA LLR for trial pairs (a[i], b[i]) over projected vectors
    (scored on the backend's device)."""
    if not isinstance(xl, torch.Tensor):
        xl = torch.from_numpy(np.array(xl))
    xl = xl.to(art.mu.device)
    a = torch.as_tensor(np.asarray(a), device=xl.device)
    b = torch.as_tensor(np.asarray(b), device=xl.device)
    return BK.to_numpy(BK.plda_score_pairs(art.plda, xl[a], xl[b]))


def evaluate_projected(art: BackendArtifact, xl, labels,
                       seed: int = 0) -> float:
    """Trial EER over already-projected vectors: the one implementation
    of the paper's trial protocol (rng(seed) -> balanced trial draw ->
    PLDA pair scoring -> EER), shared by the eval stage and
    `evaluate_ivectors` so curve and final EERs can never diverge."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    a, b, y = make_trials(labels, np.arange(len(labels)), rng)
    return BK.eer(score_trials(art, xl, a, b), y)


def evaluate_ivectors(cfg: IVectorConfig, ivecs, labels, seed: int = 0
                      ) -> Tuple[float, BackendArtifact]:
    """Train the backend on ``ivecs`` and report trial EER (the
    `pipeline.evaluate_state` math, minus the extraction)."""
    art = train_backend(cfg, ivecs, labels)
    xl = apply_backend(art, ivecs)
    return evaluate_projected(art, xl, labels, seed), art
