"""Universal background models: diagonal- and full-covariance GMMs with EM
(the port of ``repro/core/ubm.py``).

The full-covariance log-likelihood is evaluated densely through the
quadratic-form vec-trick:

    loglik[f, c] = const_c + x_f . lin_c - 0.5 * vec(x_f x_f^T) . vec(P_c)

with P_c the precision matrix (``kernels/ops.gmm_loglik``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch import resolve_device
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


def align_pack(precomp) -> torch.Tensor:
    """``full_precisions`` output -> [C, 1 + D + D(D+1)/2] packed-symmetric
    rows A2[c] = [const_c | lin_c | -0.5 triu(P_c)]: the operand of the
    fused alignment kernel, built once per UBM and cached in
    ``engine.UBMPack.align_A``."""
    const, lin, P = precomp
    C, D = lin.shape
    return ref.align_pack(const, lin.T, P.reshape(C, D * D))


def full_rescore_fused(gmm, x, sel, precomp=None, pack=None) -> torch.Tensor:
    """x: [F, D], sel: [F, K] -> [F, K] selected log-likelihoods through the
    packed-symmetric rows (``ops.gmm_rescore_fused``). ``gmm`` may be None
    when ``precomp`` or ``pack`` is given."""
    if pack is None:
        pack = align_pack(
            precomp if precomp is not None else full_precisions(gmm))
    return ops.gmm_rescore_fused(x, sel, pack)


# ---------------------------------------------------------------------------
# EM training (E-side streamed through core/engine.py; M-steps here)
# ---------------------------------------------------------------------------

VAR_FLOOR = 1e-3
WEIGHT_FLOOR = 1e-8


def init_diag_from_data(x, C: int, generator: torch.Generator,
                        mask=None) -> DiagGMM:
    """Random-frame means, global variance init.

    ``x`` may be flat [F, D] or batched [U, F, D]; with ``mask`` the means
    are drawn from (and the variance computed over) valid frames only. The
    C distinct frames are drawn by ``generator`` on its own device.
    """
    D = x.shape[-1]
    xf = x.reshape(-1, D).to(f32)
    gdev = generator.device
    if mask is None:
        idx = torch.randperm(xf.shape[0], generator=generator,
                             device=gdev)[:C]
        gvar = torch.var(xf, dim=0, unbiased=False) + VAR_FLOOR
    else:
        m = mask.reshape(-1).to(f32)
        tot = torch.clamp(m.sum(), min=1.0)
        xm = torch.where(m[:, None] > 0, xf, torch.zeros((), dtype=f32,
                                                          device=xf.device))
        mean = xm.sum(dim=0) / tot
        gvar = (xm * xm).sum(dim=0) / tot - mean ** 2 + VAR_FLOOR
        idx = torch.multinomial((m / m.sum()).to(gdev), C,
                                replacement=False, generator=generator)
    idx = idx.to(xf.device)
    return DiagGMM(torch.full((C,), 1.0 / C, dtype=f32, device=xf.device),
                   xf[idx], gvar.expand(C, D).contiguous())


def renormalised_weights(n) -> torch.Tensor:
    """Occupancies -> mixture weights: normalise, floor, renormalise (the
    floor alone would leave them summing to more than 1)."""
    w = torch.clamp(n / torch.clamp(n.sum(), min=1e-10), min=WEIGHT_FLOOR)
    return w / w.sum()


def diag_m_step(n, f, ss) -> DiagGMM:
    """M-step from streamed sufficient stats (n [C], f [C, D], ss [C, D])."""
    n_safe = torch.clamp(n, min=1e-6)
    means = f / n_safe[:, None]
    vars_ = torch.clamp(ss / n_safe[:, None] - means ** 2, min=VAR_FLOOR)
    return DiagGMM(renormalised_weights(n), means, vars_)


def full_m_step(n, f, ss) -> FullGMM:
    """M-step from streamed sufficient stats (ss [C, D, D])."""
    n_safe = torch.clamp(n, min=1e-6)
    means = f / n_safe[:, None]
    covs = (ss / n_safe[:, None, None]
            - means[:, :, None] * means[:, None, :])
    D = covs.shape[1]
    eye = torch.eye(D, dtype=covs.dtype, device=covs.device)
    covs = 0.5 * (covs + covs.transpose(1, 2)) + VAR_FLOOR * eye[None]
    return FullGMM(renormalised_weights(n), means, covs)


def psd_floor(covs, floor: float = VAR_FLOOR) -> torch.Tensor:
    """Eigenvalue-clipped covariance floor ([..., D, D]): every covariance
    comes back symmetric with spectrum >= floor."""
    covs = 0.5 * (covs + covs.transpose(-1, -2))
    lam, Q = torch.linalg.eigh(covs)
    lam = torch.clamp(lam, min=floor)
    return torch.einsum("...ir,...r,...jr->...ij", Q, lam, Q)


def full_from_diag(gmm: DiagGMM) -> FullGMM:
    return FullGMM(gmm.weights, gmm.means, torch.diag_embed(gmm.vars))


def _as_utterances(x, mask, frame_chunk: int):
    """Flat [F, D] frames (+ optional [F] mask) -> pseudo-utterances
    [U, frame_chunk, D] with the mask carried through (padded tail marked
    invalid); batched [U, F, D] input passes through."""
    if x.ndim == 3:
        return x, mask
    F, D = x.shape
    fc = min(int(frame_chunk), F)
    n_utts = -(-F // fc)
    pad = n_utts * fc - F
    feats = torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(n_utts, fc, D)
    if pad == 0 and mask is None:
        return feats, None
    m = (torch.ones((F,), dtype=f32, device=x.device) if mask is None
         else mask.reshape(F).to(f32))
    return feats, torch.nn.functional.pad(m, (0, pad)).reshape(n_utts, fc)


def train_ubm(x, C: int, generator: torch.Generator, diag_iters: int = 8,
              full_iters: int = 4, top_k: int = 0, chunk: int = 8,
              frame_chunk: int = 4096, mask=None, rescore: str = "dense",
              mesh=None, device=None) -> FullGMM:
    """The Kaldi-style recipe: diagonal EM, then full-covariance EM, with the
    E-side streamed chunk by chunk through the engine, so nothing
    frame-resident outlives one chunk.

    ``x``: flat frames [F, D] (re-chunked into ``frame_chunk``-frame
    pseudo-utterances) or padded utterances [U, F, D] with ``mask``
    [U, F]. ``top_k`` prunes the responsibilities (Kaldi's gselect); 0
    keeps all C components, which is exact EM but scatters C slots per
    chunk. ``rescore`` picks how the full phase scores the selected set.
    Runs on ``device`` (CUDA unless the caller names another).

    ``mesh`` (a ``launch.mesh.Mesh``; every rank passes the same ``x``)
    runs both EM phases through the engine's mesh mode: each rank streams
    its block of the pseudo-utterances against its block of the
    components, on the mesh's device (a one-rank mesh streams locally on
    its device). It is dropped (local streaming, as
    in the reference) when the pseudo-utterances do not divide the data
    extent or C the model extent.
    """
    from repro_torch.core import engine as EN   # engine imports ubm
    from repro_torch.launch import mesh as MS
    dev = resolve_device(device) if mesh is None else mesh.device
    if mesh is not None and mesh.size == 1:
        mesh = None
    x = torch.as_tensor(x).to(dev, f32)
    mask = None if mask is None else torch.as_tensor(mask).to(dev)
    feats, mask = _as_utterances(x, mask, frame_chunk)
    if mesh is not None and (feats.shape[0] % mesh.data_extent
                             or C % mesh.model_extent):
        mesh = None
    gmm = init_diag_from_data(feats, C, generator, mask=mask)
    if mesh is not None:
        feats = MS.data_block(mesh, feats)
        mask = MS.data_block(mesh, mask)
    K = int(top_k) if top_k else C
    spec_d = EN.EngineSpec(n_components=C, top_k=K, floor=0.0,
                           second_order="diag", chunk=chunk)
    for _ in range(diag_iters):
        st = EN.stream_ubm(spec_d, EN.pack_diag(gmm), feats, mask, mesh=mesh)
        gmm = diag_m_step(st.n, st.f, st.ss)
    full = full_from_diag(gmm)
    spec_f = EN.EngineSpec(n_components=C, top_k=K, floor=0.0,
                           second_order="full", chunk=chunk,
                           rescore=rescore)
    for _ in range(full_iters):
        st = EN.stream_ubm(spec_f, EN.pack_ubm(full, dev), feats, mask,
                           mesh=mesh)
        full = full_m_step(st.n, st.f, st.ss)
    return full
