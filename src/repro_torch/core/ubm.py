"""Universal background models: diagonal- and full-covariance GMMs (the port
of ``repro/core/ubm.py``; the M-steps and ``train_ubm`` come later).

The full-covariance log-likelihood is evaluated densely through the
quadratic-form vec-trick:

    loglik[f, c] = const_c + x_f . lin_c - 0.5 * vec(x_f x_f^T) . vec(P_c)

with P_c the precision matrix (``kernels/ops.gmm_loglik``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import ops, ref

f32 = torch.float32
_LOG2PI = 1.8378770664093453


@dataclass
class DiagGMM:
    weights: torch.Tensor  # [C]
    means: torch.Tensor    # [C, D]
    vars: torch.Tensor     # [C, D]

    @property
    def n_components(self):
        return self.weights.shape[0]


@dataclass
class FullGMM:
    weights: torch.Tensor  # [C]
    means: torch.Tensor    # [C, D]
    covs: torch.Tensor     # [C, D, D]

    @property
    def n_components(self):
        return self.weights.shape[0]

    def to_diag(self) -> DiagGMM:
        d = torch.diagonal(self.covs, dim1=1, dim2=2)
        return DiagGMM(self.weights, self.means, d)

    def to(self, device) -> "FullGMM":
        return FullGMM(self.weights.to(device), self.means.to(device),
                       self.covs.to(device))


def diag_coeffs(gmm: DiagGMM) -> Tuple[torch.Tensor, ...]:
    """(const [C], lin [D, C], quad [D, C]) natural parameters of the diag
    log-likelihood."""
    inv = 1.0 / gmm.vars
    const = (-0.5 * (torch.sum(torch.log(gmm.vars), dim=1)
                     + gmm.means.shape[1] * _LOG2PI
                     + torch.sum(gmm.means ** 2 * inv, dim=1))
             + torch.log(gmm.weights))
    return (const.to(f32), (gmm.means * inv).T.to(f32),
            (-0.5 * inv).T.to(f32))


def diag_loglik_from_coeffs(x, const, lin, quad) -> torch.Tensor:
    """x: [F, D] with ``diag_coeffs`` output -> [F, C] per-component
    log-likelihood (+ log weight), accumulated in f32."""
    x = x.to(f32)
    return const[None] + x @ lin + (x * x) @ quad


def diag_loglik(gmm: DiagGMM, x) -> torch.Tensor:
    """x: [F, D] -> [F, C] per-component log-likelihood (+ log weight)."""
    return diag_loglik_from_coeffs(x, *diag_coeffs(gmm))


def full_precisions(gmm: FullGMM) -> Tuple[torch.Tensor, ...]:
    """(const [C], lin [C, D], P [C, D, D]) for the vec-trick evaluation.

    The precision comes from an identity-RHS Cholesky solve on the factor
    already in hand, never from an LU inverse (which poisons the
    precompute on near-singular covariances), and is then symmetrised so
    that solve round-off cannot leak asymmetry into the quadratic form.
    """
    chol = torch.linalg.cholesky(gmm.covs)
    D = gmm.covs.shape[-1]
    eye = torch.eye(D, dtype=gmm.covs.dtype, device=gmm.covs.device)
    P = torch.cholesky_solve(eye.expand_as(gmm.covs), chol)
    P = 0.5 * (P + P.transpose(1, 2))
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=1, dim2=2)), dim=1)
    lin = torch.einsum("cij,cj->ci", P, gmm.means)
    const = (-0.5 * (logdet + gmm.means.shape[1] * _LOG2PI
                     + torch.einsum("ci,ci->c", gmm.means, lin))
             + torch.log(gmm.weights))
    return const.to(f32), lin.to(f32), P.to(f32)


def full_loglik(gmm: FullGMM, x, precomp=None) -> torch.Tensor:
    """x: [F, D] -> [F, C] via the dense vec-trick (the ``gmm_loglik``
    kernel on CUDA, its plain version on the CPU)."""
    const, lin, P = precomp if precomp is not None else full_precisions(gmm)
    D = x.shape[1]
    return ops.gmm_loglik(x, const, lin.T, P.reshape(-1, D * D))


def rescore_pack(precomp) -> torch.Tensor:
    """``full_precisions`` output -> [C, 1 + D + D²] packed rows
    A[c] = [const_c | lin_c | vec(P_c)]: the gather unit of the sparse
    rescoring kernel, built once per UBM and cached in
    ``engine.UBMPack``."""
    const, lin, P = precomp
    C, D = lin.shape
    return ref.rescore_pack(const, lin.T, P.reshape(C, D * D))


def full_rescore(gmm, x, sel, precomp=None, pack=None) -> torch.Tensor:
    """x: [F, D], sel: [F, K] component ids -> [F, K] loglik of ONLY the
    selected components (never materialises [F, C]). ``gmm`` may be None
    when ``precomp`` is given."""
    const, lin, P = precomp if precomp is not None else full_precisions(gmm)
    D = x.shape[1]
    return ops.gmm_rescore(x, sel, const, lin.T, P.reshape(-1, D * D),
                           pack=pack)
