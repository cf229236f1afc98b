"""CUDA kernel wrapper: sparse rescore of the selected components, grouped
by component.

Launches ``csrc/gmm_rescore.cu`` (which says what it replaces, what bounds
it and how it is laid out) on the packed rows of ``ref.rescore_pack``
([C, E] with E >= 1 + D + D*D). Ids must already lie in [0, C):
``ops.gmm_rescore`` clips them, as the contract of the JAX wrapper does.
``geometry`` gives the work-item size and the scratch the launch needs,
``work_items`` the kernel's cut of the pairs in plain tensor code.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# csrc/gmm_rescore.cu: pairs a work item at most, the rescore's warps
# along the sum over i, columns of a product pass, shared memory a block
# may have, the pair indices' limit, threads of a rescore block
THREADS = 128
BP = 64
IW = 2
COLS = 72
MAX_SMEM = 232448
MAX_PAIRS = 2 ** 31


class Geometry(NamedTuple):
    bp: int              # pairs a work item at most
    max_items: int       # work items at most: ceil(F K / bp) + C
    scratch_words: int   # int32 scratch: counts, item starts, items, order
    smem_bytes: int      # shared memory of a rescore block


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def geometry(F: int, K: int, C: int, D: int) -> Geometry:
    """The launch's geometry (``geometry`` in csrc/gmm_rescore.cu): work
    items of BP pairs, at most ceil(F*K / BP) + C of them, since a
    component's last item may be partial; the scratch, in int32 words, for
    the counts [C], the items' starts [C + 1], the items [max_items] as
    int4 and the sorted pair indices [F*K]; the shared memory of a rescore
    block (P, the item's frames, lin, const, the i-warps' parts, the
    pairs). Raises where F*K >= 2**31 (int32 pair indices), where the
    sort's histogram of C counts or a rescore block would exceed MAX_SMEM
    (D above 200)."""
    pairs = F * K
    if pairs >= MAX_PAIRS:
        raise ValueError(f"gmm_rescore: F*K = {pairs} pairs, at or above "
                         f"the 2**31 the kernel indexes")
    Dp, Di = _round_up(D, COLS), _round_up(D, 2 * IW)
    smem = 4 * (Di * Dp + 4 + BP * Dp + Dp + 4 + IW * BP + 2 * BP)
    need = max(smem, 4 * C)
    if need > MAX_SMEM:
        raise ValueError(f"gmm_rescore: C={C}, D={D} need {need} bytes of "
                         f"shared memory a block, above the {MAX_SMEM} a "
                         f"block may have")
    max_items = -(-pairs // BP) + C
    return Geometry(BP, max_items,
                    _round_up(2 * C + 1, 4) + 4 * max_items + pairs, smem)


def kernel_geometry(F: int, K: int, C: int, D: int):
    """What ``geometry`` gives, as the CUDA side computes it
    (``gmm_rescore_geometry``), or None where it refuses the shapes."""
    out = (ctypes.c_longlong * 4)()
    err = _build.load("gmm_rescore").gmm_rescore_geometry(
        F, K, C, D, ctypes.addressof(out))
    return None if err else Geometry(*out)


def work_items(counts, bp: int = BP):
    """The kernel's cut of the pairs, in plain tensor code: counts [C] pairs
    a component -> [items, 3] int64 rows (component, first pair, pairs),
    in component order, each component's segment (its pairs after those of
    the components before it) cut into items of ``bp`` pairs and a last
    one of the rest."""
    counts = counts.long()
    per = (counts + bp - 1) // bp
    comp = torch.repeat_interleave(torch.arange(counts.numel()), per)
    j = (torch.arange(int(per.sum())) -
         torch.repeat_interleave(torch.cumsum(per, 0) - per, per))
    first = (torch.cumsum(counts, 0) - counts)[comp] + j * bp
    n = torch.clamp(counts[comp] - j * bp, max=bp)
    return torch.stack([comp, first, n], dim=1)


def gmm_rescore(x, sel, A):
    """x: [F, D] f32; sel: [F, K] int64 in [0, C); A: [C, E] f32 packed
    rows, all on one CUDA device -> [F, K] f32 selected log-likelihoods."""
    F, D = x.shape
    K = sel.shape[1]
    C, E = A.shape
    if sel.shape[0] != F or E < 1 + D + D * D:
        raise ValueError(f"gmm_rescore: shapes x {tuple(x.shape)}, sel "
                         f"{tuple(sel.shape)}, A {tuple(A.shape)}")
    _build.require_cuda("gmm_rescore", x, sel, A)
    if x.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("gmm_rescore: the kernel takes float32 x and A")
    if sel.dtype != torch.int64:
        raise TypeError("gmm_rescore: sel must be int64")
    g = geometry(F, K, C, D)
    out = torch.empty((F, K), dtype=torch.float32, device=x.device)
    scratch = torch.empty(g.scratch_words, dtype=torch.int32,
                          device=x.device)
    err = _build.load("gmm_rescore").gmm_rescore_f32(
        x.data_ptr(), sel.data_ptr(), A.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), F, K, C, D, E, g.max_items, g.scratch_words,
        g.smem_bytes, *_build.launch_args(x))
    _build.check(err, "gmm_rescore")
    gmm_rescore.launches += 1
    return out


gmm_rescore.launches = 0
