"""Plain PyTorch versions of the kernels (the port of ``repro/kernels/ref.py``).

They run the CPU path and are what ``chip_smoke.py`` holds each CUDA
kernel against on the card. Every product accumulates in float32; bf16
inputs are widened first, which is exact, so only the summation order
differs from a kernel that widens per element.
"""
from __future__ import annotations

import torch

f32 = torch.float32


def _expand(x):
    """[F, D] -> [F, D*D] row-major vec(x x^T)."""
    F, D = x.shape
    return (x[:, :, None] * x[:, None, :]).reshape(F, D * D)


def gmm_loglik(x, const, lin, P_flat):
    """Full-covariance GMM log-likelihood via the vec-trick.

    x: [F, D]; const: [C]; lin: [D, C]; P_flat: [C, D*D] (row-major
    precision matrices). Returns [F, C]:
        out[f,c] = const[c] + x_f . lin[:,c] - 0.5 vec(x x^T) . P_flat[c]
    """
    x = x.to(f32)
    return const[None] + x @ lin - 0.5 * (_expand(x) @ P_flat.T)


def gmm_rescore(x, sel, const, lin, P_flat):
    """Loglik of the SELECTED components only.

    x: [F, D]; sel: [F, K] component ids in [0, C); const: [C]; lin:
    [D, C]; P_flat: [C, D*D]. Returns [F, K]:

        out[f, k] = const[sel[f,k]] + x_f . lin[:, sel[f,k]]
                    - 0.5 vec(x_f x_f^T) . P_flat[sel[f,k]]

    Duplicate indices are allowed (each slot scores independently).
    """
    x = x.to(f32)
    lin_g = lin.T[sel]                                     # [F, K, D]
    P_g = P_flat[sel]                                      # [F, K, D*D]
    return (const[sel]
            + torch.einsum("fd,fkd->fk", x, lin_g)
            - 0.5 * torch.einsum("fe,fke->fk", _expand(x), P_g))


def rescore_pack(const, lin, P_flat):
    """One gatherable row per component:
    A[c] = [const_c | lin[:, c] | P_flat[c]], shape [C, 1 + D + D*D]."""
    return torch.cat([const[:, None], lin.T, P_flat], dim=1).to(f32)


def tri_inverse(G, block: int = 16):
    """Inverse of a batched lower-triangular matrix by blocked matmuls
    (no triangular solve): G [..., R, R] lower-triangular -> G^{-1}.

    Recursion on [[A, 0], [B, C]]^{-1} = [[A^{-1}, 0],
    [-C^{-1} B A^{-1}, C^{-1}]] with halving splits; sub-blocks of size
    <= ``block`` factor G = D(I + N) (N strictly lower, nilpotent) and
    invert I + N by log-depth squaring: (I+N)^{-1} = (I-N)(I+N²)(I+N⁴)…
    Every step is a batched matmul.
    """
    R = G.shape[-1]
    if R <= block:
        eye = torch.eye(R, dtype=G.dtype, device=G.device)
        Dinv = 1.0 / torch.diagonal(G, dim1=-2, dim2=-1)
        N = G * Dinv[..., None] - eye
        X = eye - N
        M = -N
        p = 1
        while p < R:
            M = M @ M
            X = X + M @ X
            p *= 2
        return X * Dinv[..., None, :]
    h = (R + 1) // 2
    Ai = tri_inverse(G[..., :h, :h], block)
    Ci = tri_inverse(G[..., h:, h:], block)
    low = -(Ci @ (G[..., h:, :h] @ Ai))
    top = torch.cat([Ai, torch.zeros(G.shape[:-2] + (h, R - h),
                                     dtype=G.dtype, device=G.device)], -1)
    return torch.cat([top, torch.cat([low, Ci], -1)], -2)


def tvm_estep_l(n, U_packed):
    """Packed L-assembly: n [U, C] @ U_packed [C, P] -> [U, P] f32, with
    P = R(R+1)/2 the upper triangle of T_c^T Sigma_c^{-1} T_c (the packed
    L_u before adding I)."""
    return n.to(f32) @ U_packed.to(f32)


def tvm_estep_a(n, PP_packed):
    """Packed A-accumulation: n^T [C, U] @ PP_packed [U, P] -> [C, P] f32,
    A_c = Σ_u n_uc (Phi_u + φ_u φ_uᵀ) in packed form."""
    return n.to(f32).T @ PP_packed.to(f32)


def _packed_index_map(R: int, device=None):
    """[R, R] int64 map (r, s) -> row-major upper-triangle packed index,
    computed arithmetically: for r <= s, idx = r*R - r(r-1)/2 + (s-r),
    mirrored for the lower triangle."""
    i = torch.arange(R, device=device)
    r = torch.minimum(i[:, None], i[None, :])
    s = torch.maximum(i[:, None], i[None, :])
    return r * R - (r * (r - 1)) // 2 + (s - r)


def pack_symmetric(M):
    """[..., R, R] -> [..., R(R+1)/2] upper triangle (row-major)."""
    R = M.shape[-1]
    iu = torch.triu_indices(R, R, device=M.device)
    return M.reshape(M.shape[:-2] + (R * R,))[..., iu[0] * R + iu[1]]


def unpack_symmetric(Mp, R: int):
    """[..., R(R+1)/2] -> [..., R, R] symmetric: both triangles read the
    same packed entry, so the result is exactly symmetric."""
    idx = _packed_index_map(R, Mp.device).reshape(-1)
    return Mp[..., idx].reshape(Mp.shape[:-1] + (R, R))
