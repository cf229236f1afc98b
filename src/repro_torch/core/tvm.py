"""Total-variability model, standard and augmented (Kaldi) formulations: the
port of ``repro/core/tvm.py`` as far as extraction needs it (the E-step
accumulation, M-step and minimum-divergence updates come with training).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops

f32 = torch.float32


@dataclass
class TVModel:
    T: torch.Tensor          # [C, D, R]; augmented: column 0 holds m_c / p
    Sigma: torch.Tensor      # [C, D, D] residual covariances
    prior: torch.Tensor      # [R]; zeros (standard) or [p,0,...,0] (augm.)
    means: torch.Tensor      # [C, D] bias terms m_c (standard formulation)
    formulation: str         # 'standard' | 'augmented'

    @property
    def rank(self):
        return self.T.shape[2]

    def to(self, device) -> "TVModel":
        return TVModel(self.T.to(device), self.Sigma.to(device),
                       self.prior.to(device), self.means.to(device),
                       self.formulation)


def init_model(generator: torch.Generator, ubm_means, ubm_covs, R: int,
               formulation: str, prior_offset: float = 100.0) -> TVModel:
    """Paper §2.1/§2.2 initialisation: T ~ N(0, 1) drawn from
    ``generator`` (on its own device), then moved to the UBM's device."""
    C, D = ubm_means.shape
    dev = ubm_means.device
    T = torch.randn((C, D, R), generator=generator, dtype=f32,
                    device=generator.device).to(dev)
    prior = torch.zeros((R,), dtype=f32, device=dev)
    if formulation == "augmented":
        T[:, :, 0] = ubm_means / prior_offset
        prior[0] = prior_offset
    return TVModel(T=T, Sigma=ubm_covs.to(f32), prior=prior,
                   means=ubm_means.to(f32), formulation=formulation)


class Precomp(NamedTuple):
    U: torch.Tensor    # [C, R, R] T^T Σ^{-1} T; packed mode: [C, P] triu
    Pj: torch.Tensor   # [C, D, R]  Σ^{-1} T

    @property
    def packed(self) -> bool:
        """Packed-symmetric layout: U holds only the upper triangle,
        P = R(R+1)/2."""
        return self.U.ndim == 2


def precompute(model: TVModel, estep: str = "dense",
               device=None) -> Precomp:
    """T^T Σ^{-1} T and Σ^{-1} T via a Cholesky solve against T (never an
    explicit inverse), on ``device`` (CUDA unless the caller names one).

    ``estep='packed'`` stores U as its packed upper triangle [C, P];
    ``'dense'`` keeps the full [C, R, R] layout. The dense [C, R, R]
    product exists transiently in both modes (C*R*R floats: 1.3 GB at
    C=2048, R=400).
    """
    if estep not in ("dense", "packed"):
        raise ValueError(f"estep must be 'dense'|'packed', got {estep!r}")
    dev = resolve_device(device)
    T, Sigma = model.T.to(dev), model.Sigma.to(dev)
    Pj = torch.cholesky_solve(T, torch.linalg.cholesky(Sigma))
    Uc = T.transpose(1, 2) @ Pj
    # exact symmetry before packing (fp round-off from the solve)
    Uc = 0.5 * (Uc + Uc.transpose(1, 2))
    if estep == "packed":
        Uc = ops.pack_symmetric(Uc)
    return Precomp(Uc.to(f32), Pj.to(f32))


def posterior(model: TVModel, pre: Precomp, n, f, mean_only: bool = False,
              estep_dtype: str = "float32"
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """n: [U, C], f: [U, C, D] -> (phi [U, R], Phi [U, R, R] | None).

    Stats must be centred for the standard formulation and raw for the
    augmented one. With a packed ``pre`` the precision assembly runs on
    the upper triangle (``ops.tvm_estep_l``: the packed matmul kernel on
    CUDA) and unpacks only at the batched Cholesky; the Cholesky factor
    is then inverted by the matmul-only ``tri_inverse``. Dense mode keeps
    the ``cholesky_solve`` reference. ``mean_only=True`` returns
    ``Phi=None`` and never forms the covariance.
    """
    R = model.rank
    eye = torch.eye(R, dtype=f32, device=n.device)
    if pre.packed:
        Lp = ops.tvm_estep_l(n, pre.U, dtype=estep_dtype)      # [U, P]
        L = eye + ops.unpack_symmetric(Lp, R)
    else:
        L = eye + torch.einsum("uc,crs->urs", n.to(f32), pre.U)
    u, C, D = f.shape
    rhs = model.prior[None] + f.reshape(u, C * D).to(f32) @ \
        pre.Pj.reshape(C * D, R)
    chol = torch.linalg.cholesky(L)
    if pre.packed:
        Gi = ops.tri_inverse(chol)
        if mean_only:
            # two triangular mat-vecs: phi = G^{-T} (G^{-1} rhs)
            y = torch.einsum("urs,us->ur", Gi, rhs)
            return torch.einsum("usr,us->ur", Gi, y), None
        Phi = torch.einsum("uir,uis->urs", Gi, Gi)
        return torch.einsum("urs,us->ur", Phi, rhs), Phi
    phi = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
    if mean_only:
        return phi, None
    Phi = torch.cholesky_solve(eye.expand(u, R, R), chol)
    return phi, Phi


def extract_ivectors(model: TVModel, pre: Precomp, n, f,
                     estep_dtype: str = "float32") -> torch.Tensor:
    """Posterior means, centred at the prior offset (Kaldi convention),
    through the ``mean_only`` posterior."""
    phi, _ = posterior(model, pre, n, f, mean_only=True,
                       estep_dtype=estep_dtype)
    return phi - model.prior[None]
