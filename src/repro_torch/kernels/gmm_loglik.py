"""CUDA kernel wrapper: dense full-covariance GMM log-likelihood.

Launches ``csrc/gmm_loglik.cu`` (which says what it replaces, what bounds
it and how it is laid out) on the packed-symmetric operand that
``packed_weights`` builds once per call. The kernel forms the frames'
packed expansion on chip and masks ragged F and C itself.
``ops.gmm_loglik`` dispatches here for CUDA tensors and to
``ref.gmm_loglik`` for CPU tensors. ``geometry`` gives the kernel's form
for D (128-frame blocks with the pair table in shared memory, or 64-frame
blocks reading ``pair_table`` from device memory) and ``expansion`` the
A operand its codes form, in plain tensor code.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

# csrc/gmm_loglik.cu: the reduction slab, the component tile, the frame
# tiles of the narrow and the wide form, W slabs in flight, threads a
# block, shared memory a block may have
BK = 16
BN = 128
BM = 128
BM_WIDE = 64
STAGES = 3
THREADS = 256
MAX_SMEM = 232448


class Geometry(NamedTuple):
    bm: int              # frames a block
    wide: bool           # the pair table read from device memory
    smem: int            # shared-memory bytes a block


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def smem_bytes(D: int, wide: bool = False) -> int:
    """Shared memory of a block (``smem_floats`` in csrc/gmm_loglik.cu):
    the ring of W slabs, two A slabs, the x tile [D + 1][bm + 1] and, in
    the narrow form, the E2p-word pair table."""
    bm = BM_WIDE if wide else BM
    E2p = _round_up(1 + D + D * (D + 1) // 2, BK)
    return 4 * (STAGES * BK * BN + 2 * BK * bm
                + _round_up((D + 1) * (bm + 1), 4) + (0 if wide else E2p))


def geometry(D: int) -> Geometry:
    """The kernel's form for D (``geometry`` in csrc/gmm_loglik.cu): the
    narrow one (128 frames a block, the pair table in shared memory) where
    it fits, D <= 204, else the wide one (64 frames, the table from
    device memory), up to D = 767. Raises above."""
    for wide in (False, True):
        smem = smem_bytes(D, wide)
        if D >= 1 and smem <= MAX_SMEM:
            return Geometry(BM_WIDE if wide else BM, wide, smem)
    raise ValueError(f"gmm_loglik: D={D} needs {smem} bytes of shared "
                     f"memory a block, above the {MAX_SMEM} a block may "
                     f"have")


def kernel_geometry(D: int):
    """What ``geometry`` gives, as the CUDA side computes it for the launch
    (``gmm_loglik_geometry``), or None where it refuses D."""
    out = (ctypes.c_int * 3)()
    err = _build.load("gmm_loglik").gmm_loglik_geometry(
        D, ctypes.addressof(out))
    return None if err else Geometry(out[0], bool(out[1]), out[2])


def pair_table(D: int, device=None) -> torch.Tensor:
    """int32 [E2p]: the kernel's code i0 | i1 << 10 | w << 20 of reduction
    row e, A[f, e] = x̃[f, i0] x̃[f, i1] w over x̃ = [x | 1]: e = 0 the ones
    (D, D, 1); e = 1 + d x_d (d, D, 1); then the upper-triangle pairs
    (i, j) in ``ref._quad_pairs``' order, w = 1 on the diagonal and 2 off
    it; (D, D, 0) past E2. The narrow form builds these codes in shared
    memory; the wide one reads this table."""
    i0, i1, _ = ref._quad_pairs(D)
    d = torch.arange(D)
    E2 = 1 + D + i0.numel()
    pad = _round_up(E2, BK) - E2
    first = torch.cat([torch.tensor([D]), d, i0, torch.full((pad,), D)])
    second = torch.cat([torch.tensor([D]), torch.full((D,), D), i1,
                        torch.full((pad,), D)])
    w = torch.cat([torch.ones(1 + D, dtype=torch.int64),
                   torch.where(i0 == i1, 1, 2),
                   torch.zeros(pad, dtype=torch.int64)])
    table = (first | second << 10 | w << 20).to(torch.int32)
    return table if device is None else table.to(device)


@functools.lru_cache(maxsize=8)
def _table_on(D: int, device: torch.device) -> torch.Tensor:
    return pair_table(D, device)


def expansion(x, table):
    """The A operand the codes form, in plain tensor code: x [F, D],
    table from ``pair_table`` -> [F, E2p] f32, x_i0 x_i1 w (the kernel's
    product order); its first E2 columns are ``ref.expand_quadratic(x)``."""
    F, D = x.shape
    xt = torch.cat([x.float(), x.new_ones(F, 1, dtype=torch.float32)], 1)
    code = table.long().to(x.device)
    i0, i1, w = code & 1023, (code >> 10) & 1023, (code >> 20).float()
    return xt[:, i0] * xt[:, i1] * w


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
    g = geometry(D)
    _build.require_cuda("gmm_loglik", x, const, lin, P_flat)
    if any(t.dtype != torch.float32 for t in (x, const, lin, P_flat)):
        raise TypeError("gmm_loglik: the kernel takes float32 operands")
    W = packed_weights(const, lin, P_flat)
    E2 = 1 + D + D * (D + 1) // 2
    pairs = _table_on(D, x.device).data_ptr() if g.wide else None
    out = torch.empty((F, C), dtype=torch.float32, device=x.device)
    err = _build.load("gmm_loglik").gmm_loglik_f32(
        x.data_ptr(), W.data_ptr(), pairs, out.data_ptr(), F, C, D, E2,
        W.shape[0], W.shape[1], *_build.launch_args(x))
    _build.check(err, "gmm_loglik")
    gmm_loglik.launches += 1
    gmm_loglik.by_form["wide" if g.wide else "narrow"] += 1
    return out


gmm_loglik.launches = 0
# launches by form (``geometry``)
gmm_loglik.by_form = {"narrow": 0, "wide": 0}
