"""Scoring backend: centring, whitening, length-norm, LDA, two-covariance
PLDA, EER — the paper's §4.1 evaluation chain (the port of
``repro/core/backend.py``).

The small projection and scoring models are trained on the host in f64
numpy/scipy, as in the JAX package, so the same numpy input gives bitwise
the same LDA and PLDA in both packages; their results become f32 tensors
on the caller's device. Scoring is torch, on that device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import scipy.linalg as sla
import torch

from repro_torch import resolve_device

f32 = torch.float32


def length_norm(x):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-10)


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _out_device(x, device) -> torch.device:
    """Where a host-trained model goes: ``device`` if named, else the
    device of the tensor it was trained from (CUDA for numpy input)."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def _f32(a: np.ndarray, dev) -> torch.Tensor:
    # numpy rounds f64 -> f32, as the JAX package's jnp.asarray does
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev)


def whitener(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, W) with W whitening the centred data. f32, with the JAX
    package's +1e-6 I on the covariance."""
    mu = torch.mean(x, dim=0)
    xc = x - mu
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    cov = xc.T @ xc / x.shape[0] + 1e-6 * eye
    lam, Q = torch.linalg.eigh(cov)
    W = (Q * torch.clamp(lam, min=1e-10) ** -0.5) @ Q.T
    return mu, W


@dataclass
class LDA:
    mean: torch.Tensor
    proj: torch.Tensor  # [D, K]

    def to(self, device) -> "LDA":
        return LDA(self.mean.to(device), self.proj.to(device))


def train_lda(x, labels, out_dim: int, device=None) -> LDA:
    """Classic Fisher LDA via generalized eigenproblem Sb v = λ Sw v."""
    dev = _out_device(x, device)
    x = np.asarray(to_numpy(x), np.float64)
    labels = to_numpy(labels)
    classes = np.unique(labels)
    mu = x.mean(axis=0)
    D = x.shape[1]
    Sw = np.zeros((D, D))
    Sb = np.zeros((D, D))
    for c in classes:
        xc = x[labels == c]
        mc = xc.mean(axis=0)
        d = xc - mc
        Sw += d.T @ d
        g = (mc - mu)[:, None]
        Sb += xc.shape[0] * (g @ g.T)
    Sw = Sw / x.shape[0] + 1e-4 * np.eye(D)
    Sb = Sb / x.shape[0]
    evals, evecs = sla.eigh(Sb, Sw)
    order = np.argsort(evals)[::-1][:out_dim]
    return LDA(_f32(mu, dev), _f32(evecs[:, order], dev))


def apply_lda(lda: LDA, x):
    return (x - lda.mean) @ lda.proj


@dataclass
class PLDA:
    mean: torch.Tensor
    B: torch.Tensor  # between-class covariance
    W: torch.Tensor  # within-class covariance

    def to(self, device) -> "PLDA":
        return PLDA(self.mean.to(device), self.B.to(device),
                    self.W.to(device))


def train_plda(x, labels, device=None) -> PLDA:
    """Two-covariance PLDA from moment estimates."""
    dev = _out_device(x, device)
    x = np.asarray(to_numpy(x), np.float64)
    labels = to_numpy(labels)
    classes = np.unique(labels)
    mu = x.mean(axis=0)
    D = x.shape[1]
    Sw = np.zeros((D, D))
    means = []
    for c in classes:
        xc = x[labels == c]
        mc = xc.mean(axis=0)
        means.append(mc)
        d = xc - mc
        Sw += d.T @ d
    Sw = Sw / x.shape[0]
    M = np.stack(means) - mu
    Sb = M.T @ M / len(classes)
    eye = np.eye(D)
    return PLDA(_f32(mu, dev), _f32(Sb + 1e-6 * eye, dev),
                _f32(Sw + 1e-6 * eye, dev))


def _spd_inverse(M):
    """SPD inverse + logdet via Cholesky and an identity-RHS
    ``cholesky_solve``, never an LU inverse: the Cholesky solve is
    backward-stable on the near-singular within-class covariances PLDA
    sees after LDA. The result is symmetrised (f32 round-off breaks exact
    symmetry) so the quadratic forms downstream stay symmetric."""
    chol = torch.linalg.cholesky(M)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    Minv = torch.cholesky_solve(eye, chol)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    return 0.5 * (Minv + Minv.T), logdet


def _plda_coeffs(plda: PLDA):
    """(Q, P, const) of the two-covariance LLR quadratic form:

    llr = log N([x;y]; 0, [[T, B],[B, T]]) - log N([x;y]; 0, [[T, 0],[0, T]])
    with T = B + W; expands to 0.5 x'Qx + 0.5 y'Qy + x'Py + const.

    T and its Schur complement S = T - B T^{-1} B are SPD, so both inverses
    run through Cholesky, and the joint log-determinant follows from
    det([[T, B],[B, T]]) = det(T) det(S).
    """
    B, W = plda.B, plda.W
    T = B + W
    Tinv, logdet_T = _spd_inverse(T)
    S = T - B @ Tinv @ B          # Schur complement
    Sinv, logdet_S = _spd_inverse(S)
    Q = Tinv - Sinv               # x'Qx coefficient
    P = Sinv @ B @ Tinv           # cross coefficient
    # logdet_joint - 2 logdet_T == (logdet_T + logdet_S) - 2 logdet_T
    const = -0.5 * (logdet_S - logdet_T)
    return Q, P, const


def plda_score_matrix(plda: PLDA, enroll, test) -> torch.Tensor:
    """LLR for every (enroll, test) pair: [N_enroll, N_test]."""
    Q, P, const = _plda_coeffs(plda)
    x = enroll - plda.mean
    y = test - plda.mean
    qx = torch.sum((x @ Q) * x, dim=1)
    qy = torch.sum((y @ Q) * y, dim=1)
    cross = (x @ P) @ y.T
    return 0.5 * (qx[:, None] + qy[None, :]) + cross + const


def plda_score_pairs(plda: PLDA, enroll, test) -> torch.Tensor:
    """LLR for N aligned (enroll[i], test[i]) trial pairs: [N], in O(N)."""
    Q, P, const = _plda_coeffs(plda)
    x = enroll - plda.mean
    y = test - plda.mean
    qx = torch.sum((x @ Q) * x, dim=1)
    qy = torch.sum((y @ Q) * y, dim=1)
    cross = torch.sum((x @ P) * y, dim=1)
    return 0.5 * (qx + qy) + cross + const


def eer(scores, labels) -> float:
    """Equal error rate; scores: [N], labels: [N] (1 target, 0 nontarget)."""
    s = np.asarray(to_numpy(scores), np.float64)
    l = to_numpy(labels)
    order = np.argsort(s)
    l_sorted = l[order]
    n_tar = max(int(l_sorted.sum()), 1)
    n_non = max(int((1 - l_sorted).sum()), 1)
    # sweeping the threshold upward: miss grows, false-alarm shrinks
    miss = np.concatenate([[0.0], np.cumsum(l_sorted) / n_tar])
    fa = np.concatenate([[1.0], 1.0 - np.cumsum(1 - l_sorted) / n_non])
    idx = np.argmin(np.abs(miss - fa))
    return float(0.5 * (miss[idx] + fa[idx]))
