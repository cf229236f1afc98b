"""CUDA kernel wrapper: dense full-covariance GMM log-likelihood.

Launches ``csrc/gmm_loglik.cu`` (which says what it replaces, what bounds
it and how it is laid out) on the packed-symmetric operand that
``packed_weights`` builds once per call. The kernel forms the frames'
packed expansion on chip and masks ragged F and C itself.
``ops.gmm_loglik`` dispatches here for CUDA tensors and to
``ref.gmm_loglik`` for CPU tensors.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

# csrc/gmm_loglik.cu: the reduction slab, the component and frame tiles,
# W slabs in flight, threads a block
BK = 16
BN = 128
BM = 128
STAGES = 3
THREADS = 256


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def smem_bytes(D: int) -> int:
    """Shared memory of a block (``smem_floats`` in csrc/gmm_loglik.cu):
    the ring of W slabs, two A slabs, the x tile [D + 1][BM + 1] and the
    E2p-word pair table."""
    E2p = _round_up(1 + D + D * (D + 1) // 2, BK)
    return 4 * (STAGES * BK * BN + 2 * BK * BM
                + _round_up((D + 1) * (BM + 1), 4) + E2p)


@functools.lru_cache(maxsize=8)
def _pair_columns(D: int, device: torch.device):
    """The columns of P_flat for ``ref._quad_pairs``' pairs: i0*D + i1 for
    each pair, then i1*D + i0 for each pair."""
    i0, i1, _ = ref._quad_pairs(D, device)
    return torch.cat([i0 * D + i1, i1 * D + i0])


def packed_weights(const, lin, P_flat):
    """The kernel's operand W [E2p, Cp] f32, E2-major: ``ref.align_pack``'s
    rows [const | lin | -0.5 triu(P)] of the symmetric part (P + Pᵀ)/2
    (xᵀPx = xᵀ(P + Pᵀ)x/2 for any P), transposed, zero-padded to E2p (a
    multiple of BK) rows and Cp (a multiple of BN) columns.

    W[:E2, :C] times ``ref.expand_quadratic(x)`` is ``ref.gmm_loglik``;
    for a symmetric P it equals ``ref.align_pack(...).T`` exactly. Plain
    tensor code, on any device."""
    C = const.shape[0]
    D = lin.shape[0]
    cols = _pair_columns(D, P_flat.device)
    n = cols.shape[0] // 2
    both = P_flat.to(torch.float32).index_select(1, cols)      # [C, 2n]
    quad = both[:, :n].add(both[:, n:]).mul_(-0.25)
    E2 = 1 + D + n
    W = torch.empty((_round_up(E2, BK), _round_up(C, BN)),
                    dtype=torch.float32, device=const.device)
    W[E2:].zero_()
    W[:E2, C:].zero_()
    W[0, :C] = const
    W[1:1 + D, :C] = lin
    W[1 + D:E2, :C] = quad.T
    return W


def gmm_loglik(x, const, lin, P_flat):
    """x: [F, D]; const: [C]; lin: [D, C]; P_flat: [C, D*D], all f32 on
    one CUDA device -> [F, C] f32."""
    F, D = x.shape
    C = const.shape[0]
    if lin.shape != (D, C) or P_flat.shape != (C, D * D):
        raise ValueError(f"gmm_loglik: shapes x {tuple(x.shape)}, lin "
                         f"{tuple(lin.shape)}, P_flat {tuple(P_flat.shape)}")
    if D > 254:
        raise ValueError(f"gmm_loglik: D={D} above the kernel's 254")
    _build.require_cuda("gmm_loglik", x, const, lin, P_flat)
    if any(t.dtype != torch.float32 for t in (x, const, lin, P_flat)):
        raise TypeError("gmm_loglik: the kernel takes float32 operands")
    W = packed_weights(const, lin, P_flat)
    E2 = 1 + D + D * (D + 1) // 2
    out = torch.empty((F, C), dtype=torch.float32, device=x.device)
    err = _build.load("gmm_loglik").gmm_loglik_f32(
        x.data_ptr(), W.data_ptr(), out.data_ptr(), F, C, D, E2,
        W.shape[0], W.shape[1], *_build.launch_args(x))
    _build.check(err, "gmm_loglik")
    gmm_loglik.launches += 1
    return out


gmm_loglik.launches = 0
