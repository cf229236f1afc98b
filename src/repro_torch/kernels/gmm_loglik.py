"""CUDA kernel wrapper: dense full-covariance GMM log-likelihood.

Launches ``csrc/gmm_loglik.cu`` (which says what it replaces, what bounds
it and how it is laid out) on the packed-symmetric operand that
``packed_weights`` builds once per call. The kernel forms the frames'
packed expansion on chip and masks ragged F and C itself.
``ops.gmm_loglik`` dispatches here for CUDA tensors and to
``ref.gmm_loglik`` for CPU tensors. ``geometry`` gives the kernel's form
for D: the narrow one (128-frame blocks forming the packed expansion from
the codes of ``pair_table`` in shared memory; ``expansion`` is that A
operand in plain tensor code) up to D = 204, else the rows form (the sum
factored by rows of the triangle on the tensor cores in 3xTF32, on the
row runs that ``pack_rows`` packs with a kernel of its own, bitwise
``row_weights``; ``row_sums`` is its arithmetic in plain tensor code).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

# csrc/gmm_loglik.cu: the narrow form's reduction slab, component and
# frame tiles, W slabs in flight; threads a block, shared memory a block
# may have; the rows form's component tile, W positions a slab, a W slab
# row's stride, W slabs in flight
BK = 16
BN = 128
BM = 128
STAGES = 3
THREADS = 256
MAX_SMEM = 232448
RBN = 128
KS = 32
LDW = KS + 8
RING = 3


class Geometry(NamedTuple):
    bm: int              # frames a block
    wide: bool           # the rows form (D >= 205)
    smem: int            # shared-memory bytes a block


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def smem_bytes(D: int, wide: bool = False, mt: int = 4) -> int:
    """Shared memory of a block (csrc/gmm_loglik.cu): the narrow form's
    ring of W slabs, two A slabs, the x tile [D + 1][BM + 1] and the
    E2p-word pair table (``smem_floats``); the rows form's ring of
    [RBN][LDW] W slabs and the x tile of 32 mt frames, ``rows_ldx(D)``
    floats a frame (``rows::smem_bytes``)."""
    if wide:
        return 4 * (RING * RBN * LDW + 32 * mt * rows_ldx(D))
    E2p = _round_up(1 + D + D * (D + 1) // 2, BK)
    return 4 * (STAGES * BK * BN + 2 * BK * BM
                + _round_up((D + 1) * (BM + 1), 4) + E2p)


def rows_ldx(D: int) -> int:
    """The rows form's x tile row stride: D rounded up to 8, then up to 8
    more than a multiple of 32 (conflict-free fragment loads)."""
    dx = _round_up(D, 8)
    return dx + (8 - dx) % 32


def geometry(D: int) -> Geometry:
    """The kernel's form for D (``geometry`` in csrc/gmm_loglik.cu): the
    narrow one (128 frames a block, the pair table in shared memory) where
    it fits, D <= 204, else the rows form with the most frames a block
    that fit: 128 up to D = 328, 64 up to 648, 32 up to 1,320. Raises
    above."""
    if D >= 1 and smem_bytes(D) <= MAX_SMEM:
        return Geometry(BM, False, smem_bytes(D))
    for mt in (4, 2, 1):
        smem = smem_bytes(D, True, mt)
        if D >= 1 and smem <= MAX_SMEM:
            return Geometry(32 * mt, True, smem)
    raise ValueError(f"gmm_loglik: D={D} needs {smem} bytes of shared "
                     f"memory a block, above the {MAX_SMEM} a block may "
                     f"have")


def kernel_geometry(D: int):
    """What ``geometry`` gives, and the rows form's W positions
    (``rows_positions``; 0 for the narrow form), as the CUDA side computes
    them for the launch (``gmm_loglik_geometry``), or None where it refuses
    D."""
    out = (ctypes.c_int * 4)()
    err = _build.load("gmm_loglik").gmm_loglik_geometry(
        D, ctypes.addressof(out))
    return None if err else (Geometry(out[0], bool(out[1]), out[2]),
                             out[3])


def row_schedule(D: int):
    """The rows form's rows in kernel order -> a list of (first x column
    j0, chunks of 8 positions): the linear row (0, Dx / 8), then quadratic
    row i (8 floor(i / 8), Dx / 8 - floor(i / 8)), Dx = D rounded up to
    8."""
    ng = _round_up(D, 8) // 8
    return [(0, ng)] + [(8 * (i // 8), ng - i // 8) for i in range(D)]


def rows_positions(D: int) -> int:
    """K, the rows form's W positions: 8 for each chunk of each row,
    rounded up to a whole slab of KS (``rows::positions`` in the .cu)."""
    return _round_up(8 * sum(n for _, n in row_schedule(D)), KS)


@functools.lru_cache(maxsize=8)
def _row_index(D: int, device: torch.device):
    """For each of the rows form's K positions: the two columns of P_flat
    whose sum gives its weight and its factor, -0.25 w on quadratic row
    i's triangle (w = 2 off the diagonal) and 0 elsewhere (the linear
    row, whose first D positions take lin, below the triangle, past D,
    past the last row). -> (first [K], second [K], factor [K])."""
    K = rows_positions(D)
    first = torch.zeros(K, dtype=torch.int64)
    second = torch.zeros(K, dtype=torch.int64)
    factor = torch.zeros(K)
    sched = row_schedule(D)
    pos = 8 * sched[0][1]
    for i, (j0, n) in enumerate(sched[1:]):
        j = torch.arange(j0, j0 + 8 * n)
        sl = slice(pos, pos + 8 * n)
        on = (j >= i) & (j < D)
        jc = j.clamp(max=D - 1)
        first[sl] = i * D + jc
        second[sl] = jc * D + i
        factor[sl] = torch.where(on, torch.where(j == i, -0.25, -0.5), 0.0)
        pos += 8 * n
    return (first.to(torch.int32).to(device),
            second.to(torch.int32).to(device), factor.to(device))


def row_weights(const, lin, P_flat):
    """The rows form's operand Wr [Cp, K] f32, component-major: for each
    row of ``row_schedule`` its run of 8-position chunks, lin[j] on the
    linear row, -0.25 w (P_ij + P_ji) on quadratic row i at j >= i (w =
    2 off the diagonal: the same value as ``packed_weights``' row times
    its pair's weight, both exact in f32), zero elsewhere and past C.
    Plain tensor code, on any device; const is not in it (the kernel adds
    it to each output)."""
    C = const.shape[0]
    D = lin.shape[0]
    first, second, factor = _row_index(D, P_flat.device)
    first, second = first.long(), second.long()
    P32 = P_flat.to(torch.float32)
    out = torch.empty((_round_up(C, RBN), first.shape[0]),
                      dtype=torch.float32, device=const.device)
    out[C:].zero_()
    Wr = out[:C]
    torch.index_select(P32, 1, first, out=Wr)
    Wr.add_(P32.index_select(1, second)).mul_(factor)
    Wr[:, :D] = lin.T
    return out


def pack_rows(const, lin, P_flat):
    """``row_weights`` on the card: the same operand, bitwise, from one
    launch of the packing kernel (``gmm_loglik_pack_f32``) that reads
    each component's P once. f32 CUDA tensors."""
    C = const.shape[0]
    D = lin.shape[0]
    first, second, factor = _row_index(D, P_flat.device)
    Cp = _round_up(C, RBN)
    Wr = torch.empty((Cp, first.shape[0]), dtype=torch.float32,
                     device=P_flat.device)
    P32, l32 = P_flat.contiguous(), lin.contiguous()
    err = _build.load("gmm_loglik").gmm_loglik_pack_f32(
        P32.data_ptr(), l32.data_ptr(), first.data_ptr(), second.data_ptr(),
        factor.data_ptr(), Wr.data_ptr(), C, Cp, D, first.shape[0],
        *_build.launch_args(P_flat))
    _build.check(err, "gmm_loglik")
    return Wr


def tf32_split(v):
    """(hi, lo) as the rows form's products read them, f32 tensors: hi is
    v's TF32 rounding to nearest, ties away from zero
    (``cvt.rna.tf32.f32``); lo is v - hi (exact) with its low 13 mantissa
    bits dropped, as the tensor cores read a TF32 operand."""
    b = v.contiguous().view(torch.int32)
    hi = ((b + 0x1000) & -0x2000).view(torch.float32)
    lo = ((v - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def row_sums(x, const, Wr):
    """The rows form's arithmetic in plain tensor code: each row's inner
    sum over its chunks as the kernel's 3xTF32 product (lo_a hi_b + hi_a
    lo_b + hi_a hi_b, each an f32 matmul), times its multiplier (1, or
    x_i) added into the totals in row order, const added last. x [F, D],
    const [C], Wr from ``row_weights`` -> [F, C] f32."""
    F, D = x.shape
    C = const.shape[0]
    xt = torch.zeros((F, _round_up(D, 8)), dtype=torch.float32,
                     device=x.device)
    xt[:, :D] = x
    xh, xl = tf32_split(xt)
    wh, wl = tf32_split(Wr[:C])
    tot = torch.zeros((F, C), dtype=torch.float32, device=x.device)
    pos = 0
    for r, (j0, n) in enumerate(row_schedule(D)):
        a, k = slice(j0, j0 + 8 * n), slice(pos, pos + 8 * n)
        inner = (xl[:, a] @ wh[:, k].T + xh[:, a] @ wl[:, k].T
                 + xh[:, a] @ wh[:, k].T)
        tot = tot + (inner if r == 0 else x[:, r - 1:r] * inner)
        pos += 8 * n
    return tot + const


def pair_table(D: int, device=None) -> torch.Tensor:
    """int32 [E2p]: the kernel's code i0 | i1 << 10 | w << 20 of reduction
    row e, A[f, e] = x̃[f, i0] x̃[f, i1] w over x̃ = [x | 1]: e = 0 the ones
    (D, D, 1); e = 1 + d x_d (d, D, 1); then the upper-triangle pairs
    (i, j) in ``ref._quad_pairs``' order, w = 1 on the diagonal and 2 off
    it; (D, D, 0) past E2: the codes the narrow form builds in shared
    memory."""
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
    out = torch.empty((F, C), dtype=torch.float32, device=x.device)
    if g.wide:
        W, cst = pack_rows(const, lin, P_flat), const.contiguous()
        Kw, Cp = W.shape[1], W.shape[0]
    else:
        W, cst = packed_weights(const, lin, P_flat), None
        Kw, Cp = W.shape
    err = _build.load("gmm_loglik").gmm_loglik_f32(
        x.data_ptr(), W.data_ptr(), None if cst is None else cst.data_ptr(),
        out.data_ptr(), F, C, D, Kw, Cp, *_build.launch_args(x))
    _build.check(err, "gmm_loglik")
    gmm_loglik.launches += 1
    gmm_loglik.by_form["wide" if g.wide else "narrow"] += 1
    return out


gmm_loglik.launches = 0
# launches by form (``geometry``; "wide" is the rows form)
gmm_loglik.by_form = {"narrow": 0, "wide": 0}
