"""Total-variability model, standard and augmented (Kaldi) formulations: the
port of ``repro/core/tvm.py``.

  * E-step posteriors (paper eqs. 3-4), with prior offset p (augmented)
  * E-step accumulation and the M-step: T update, residual covariance Σ_c
  * minimum-divergence re-estimation: whitening; for the augmented
    formulation also the Householder reflection and the prior-offset update
  * UBM-mean write-back for realignment (paper §3.2 step 5)
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import mesh as MS

f32 = torch.float32
COV_FLOOR = 1e-4


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


def _model_sum(axis, t):
    """Sum of the partial ``t`` over the model axis of the mesh ``axis``
    (None: ``t`` is already whole)."""
    if axis is None:
        return t
    return MS.all_reduce(axis, t, axis.groups["model"], "model")


def posterior(model: TVModel, pre: Precomp, n, f, mean_only: bool = False,
              estep_dtype: str = "float32", axis=None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """n: [U, C], f: [U, C, D] -> (phi [U, R], Phi [U, R, R] | None).

    Stats must be centred for the standard formulation and raw for the
    augmented one. With a packed ``pre`` the precision assembly runs on
    the upper triangle (``ops.tvm_estep_l``: the packed matmul kernel on
    CUDA) and unpacks only at the batched Cholesky; the Cholesky factor
    is then inverted by the matmul-only ``tri_inverse``. Dense mode keeps
    the ``cholesky_solve`` reference. ``mean_only=True`` returns
    ``Phi=None`` and never forms the covariance.

    ``axis`` (the engine's mesh mode: a ``launch.mesh.Mesh`` whose model
    axis is sharded): n/f and the precompute rows cover only the rank's
    block of components, so the component contractions are partial sums.
    They sum over the model axis before the eye and prior terms are
    added, and everything after (solves, phi, Phi) is replicated over the
    model axis: the E-step's only model-axis collective.
    """
    R = model.rank
    eye = torch.eye(R, dtype=f32, device=n.device)
    if pre.packed:
        Lp = ops.tvm_estep_l(n, pre.U, dtype=estep_dtype)      # [U, P]
        L = eye + ops.unpack_symmetric(_model_sum(axis, Lp), R)
    else:
        Ld = torch.einsum("uc,crs->urs", n.to(f32), pre.U)
        L = eye + _model_sum(axis, Ld)
    u, C, D = f.shape
    rhs = model.prior[None] + _model_sum(
        axis, f.reshape(u, C * D).to(f32) @ pre.Pj.reshape(C * D, R))
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


class EMAccum(NamedTuple):
    A: torch.Tensor       # [C, R, R] Σ_u n_uc (Phi_u + phi phi^T);
    #                       packed mode: [C, P] upper triangle
    B: torch.Tensor       # [C, D, R] Σ_u f_uc ⊗ phi_u
    h: torch.Tensor       # [R]       Σ_u phi_u
    H: torch.Tensor       # [R, R]    Σ_u (Phi_u + phi phi^T)
    n_tot: torch.Tensor   # [C]
    n_utts: torch.Tensor  # []

    @staticmethod
    def zeros(C: int, D: int, R: int, estep: str = "dense",
              device=None) -> "EMAccum":
        """Identity element of ``merge_accums`` on ``device``.
        ``estep='packed'`` sizes A as the packed triangle [C, P]."""
        def z(*shape):
            return torch.zeros(shape, dtype=f32, device=device)
        A0 = z(C, R * (R + 1) // 2) if estep == "packed" else z(C, R, R)
        return EMAccum(A=A0, B=z(C, D, R), h=z(R), H=z(R, R), n_tot=z(C),
                       n_utts=z())


def em_accumulate(model: TVModel, pre: Precomp, n, f,
                  estep_dtype: str = "float32", axis=None) -> EMAccum:
    """One minibatch of utterance stats -> E-step accumulators.

    A packed ``pre`` keeps the symmetric operands packed end to end: the
    per-utterance second moment Phi + φφᵀ is packed once [U, P], the
    A-accumulation runs on it (``ops.tvm_estep_a``: the packed matmul
    kernel on CUDA) and A stays packed until the M-step solve.

    With ``axis`` (model-sharded n/f/pre) the posterior sums its partial
    precision and rhs over the model axis; phi/Phi come back replicated,
    so A/B/n_tot are this rank's rows of the whole accumulators and
    h/H/n_utts are replicated: the layout the engine's exit reduce
    expects.
    """
    phi, Phi = posterior(model, pre, n, f, estep_dtype=estep_dtype,
                         axis=axis)
    if pre.packed:
        i0, i1 = torch.triu_indices(model.rank, model.rank, device=n.device)
        PPp = ops.pack_symmetric(Phi) + phi[:, i0] * phi[:, i1]
        A = ops.tvm_estep_a(n, PPp, dtype=estep_dtype)         # [C, P]
        H = ops.unpack_symmetric(PPp.sum(dim=0), model.rank)
    else:
        PP = Phi + phi[:, :, None] * phi[:, None, :]
        A = torch.einsum("uc,urs->crs", n.to(f32), PP)
        H = PP.sum(dim=0)
    B = torch.einsum("ucd,ur->cdr", f.to(f32), phi)
    return EMAccum(A=A, B=B, h=phi.sum(dim=0), H=H,
                   n_tot=n.to(f32).sum(dim=0),
                   n_utts=torch.tensor(float(n.shape[0]), dtype=f32,
                                       device=n.device))


def merge_accums(a: EMAccum, b: EMAccum) -> EMAccum:
    return EMAccum(*(x + y for x, y in zip(a, b)))


def em_accumulate_scan(model: TVModel, pre: Precomp, n, f,
                       chunk: int = 512,
                       estep_dtype: str = "float32") -> EMAccum:
    """Chunked E-step: utterance sub-batches of ``chunk`` in order, then the
    ragged tail as one remainder chunk, merged in that order (the JAX
    ``lax.scan`` and its tail), so the per-utterance posterior covariances
    exist only [chunk, R, R] at a time."""
    U_, C = n.shape
    chunk = min(chunk, U_)
    R, D = model.rank, model.T.shape[1]
    acc = EMAccum.zeros(C, D, R, estep="packed" if pre.packed else "dense",
                        device=n.device)
    for s in range(0, U_, chunk):
        acc = merge_accums(acc, em_accumulate(
            model, pre, n[s:s + chunk], f[s:s + chunk],
            estep_dtype=estep_dtype))
    return acc


def m_step(model: TVModel, acc: EMAccum, S_tot: Optional[torch.Tensor],
           update_sigma: bool) -> TVModel:
    """T update (and Σ update) from accumulated statistics [Kenny 2005].

    A packed accumulator ([C, P]) is unpacked here, at the solve. T_c =
    B_c A_c^{-1} comes from a batched solve against the regularised A_c,
    never from an explicit inverse.
    """
    R = model.rank
    A = ops.unpack_symmetric(acc.A, R) if acc.A.ndim == 2 else acc.A
    eye_r = torch.eye(R, dtype=f32, device=A.device)
    T_new = torch.linalg.solve(A + 1e-6 * eye_r[None],
                               acc.B.transpose(1, 2)).transpose(1, 2)
    Sigma = model.Sigma
    if update_sigma and S_tot is not None:
        n_safe = torch.clamp(acc.n_tot, min=1e-6)[:, None, None]
        TB = torch.einsum("cdr,cer->cde", T_new, acc.B)
        Sigma = (S_tot - 0.5 * (TB + TB.transpose(1, 2))) / n_safe
        D = Sigma.shape[1]
        eye_d = torch.eye(D, dtype=f32, device=A.device)
        Sigma = 0.5 * (Sigma + Sigma.transpose(1, 2)) + COV_FLOOR * eye_d[None]
    return replace(model, T=T_new.contiguous().to(f32),
                   Sigma=Sigma.to(f32))


def min_divergence(model: TVModel, acc: EMAccum,
                   update_means: bool = False) -> TVModel:
    """Minimum-divergence re-estimation (paper §3.1). The eigenvectors of
    G are defined up to sign, so T's columns 2..R (and their signs) may
    differ between LAPACK, cuSOLVER and JAX; the quantities the model
    computes (T_c T_c^T, the i-vector Gram matrix) do not."""
    nu = torch.clamp(acc.n_utts, min=1.0)
    h = acc.h / nu
    R = model.rank
    eye = torch.eye(R, dtype=f32, device=h.device)
    G = acc.H / nu - h[:, None] * h[None, :] + 1e-8 * eye
    lam, Q = torch.linalg.eigh(G)
    lam = torch.clamp(lam, min=1e-10)
    P1 = (Q * (lam ** -0.5)[None, :]).T            # Λ^{-1/2} Q^T
    P1_inv = Q * (lam ** 0.5)[None, :]             # Q Λ^{1/2}

    if model.formulation == "standard":
        T_new = torch.einsum("cdr,rs->cds", model.T, P1_inv)
        means = model.means
        if update_means:
            # paper §5: m_c^upd = m_c + T_c h  (old T)
            means = means + torch.einsum("cdr,r->cd", model.T, h)
        return replace(model, T=T_new.to(f32), means=means)

    # augmented: also require P2 P1 h = b e1 (Householder, eqs. 8-11)
    p1h = P1 @ h
    h_t = p1h / torch.clamp(torch.linalg.norm(p1h), min=1e-10)
    # e1 as a comparison: a Python number written into a tensor dispatches
    # a scalar_tensor on meta and none on the CPU, so a lowered iteration
    # would count other ops than a run (``analysis/op_cost.py``)
    e1 = (torch.arange(R, device=h.device) == 0).to(f32)
    denom = torch.clamp(2.0 * (1.0 - h_t[0]), min=1e-10)
    alpha = denom ** -0.5
    a = alpha * h_t - alpha * e1
    # degenerate case: h already along e1 -> P2 = I
    degenerate = (1.0 - h_t[0]) < 1e-8
    P2 = torch.where(degenerate, eye, eye - 2.0 * a[:, None] * a[None, :])
    # T <- T P1^{-1} P2^{-1}; P2 is a reflection: P2^{-1} = P2
    T_new = torch.einsum("cdr,rs,st->cdt", model.T, P1_inv, P2)
    prior = torch.where(degenerate, p1h, P2 @ p1h)
    return replace(model, T=T_new.to(f32), prior=prior.to(f32))


def updated_ubm_means(model: TVModel) -> torch.Tensor:
    """New UBM means: augmented = first column of T times p; standard = m_c."""
    if model.formulation == "augmented":
        return model.T[:, :, 0] * model.prior[0]
    return model.means


def extract_ivectors(model: TVModel, pre: Precomp, n, f,
                     estep_dtype: str = "float32") -> torch.Tensor:
    """Posterior means, centred at the prior offset (Kaldi convention),
    through the ``mean_only`` posterior."""
    phi, _ = posterior(model, pre, n, f, mean_only=True,
                       estep_dtype=estep_dtype)
    return phi - model.prior[None]
