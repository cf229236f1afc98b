"""CUDA kernel wrapper: sparse rescore of the selected components, grouped
by component.

Launches ``csrc/gmm_rescore.cu`` (which says what it replaces, what bounds
it and how it is laid out) on the packed rows of ``ref.rescore_pack``
([C, E] with E >= 1 + D + D*D). Ids must already lie in [0, C):
``ops.gmm_rescore`` clips them, as the contract of the JAX wrapper does.
``geometry`` gives the work-item size, the scratch and the form the launch
needs (P whole or in strips, the sort's histogram in shared or device
memory), ``work_items`` the kernel's cut of the pairs and ``strip_scores``
the strip form's sums, in plain tensor code.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# csrc/gmm_rescore.cu: pairs a work item at most, the rescore's warps
# along the sum over i, columns of a product pass, rows of P a strip in the
# strip form, shared memory a block may have, the pair indices' limit,
# threads of a rescore block
THREADS = 128
BP = 64
IW = 2
COLS = 72
STRIP = 32
MAX_SMEM = 232448
MAX_PAIRS = 2 ** 31


class Geometry(NamedTuple):
    bp: int              # pairs a work item at most
    max_items: int       # work items at most: ceil(F K / bp) + C
    scratch_words: int   # int32 scratch: counts, item starts, items, order
    smem_bytes: int      # shared memory of a rescore block
    strip: int           # rows of P a pass: all (p_rows(D)) or STRIP
    hist_global: int     # 1: the sort's counts in device memory


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def p_rows(D: int) -> int:
    """Rows of P a rescore block keeps whole: D rounded up to 2 IW."""
    return _round_up(D, 2 * IW)


def smem_bytes(D: int, rows: int) -> int:
    """Shared memory of a rescore block keeping ``rows`` rows of P
    (``smem_words`` in csrc/gmm_rescore.cu): P's rows, the item's frames,
    lin, const, the i-warps' parts, the pairs."""
    Dp = _round_up(D, COLS)
    return 4 * (rows * Dp + 4 + BP * Dp + Dp + 4 + IW * BP + 2 * BP)


def geometry(F: int, K: int, C: int, D: int) -> Geometry:
    """The launch's geometry (``geometry`` in csrc/gmm_rescore.cu): work
    items of BP pairs, at most ceil(F*K / BP) + C of them, since a
    component's last item may be partial; the scratch, in int32 words, for
    the counts [C], the items' starts [C + 1], the items [max_items] as
    int4 and the sorted pair indices [F*K]; the shared memory of a rescore
    block with P whole where it fits (D <= 200), else in strips of STRIP
    rows; the sort's histogram in shared memory where C counts fit (C <=
    58,112), else in device memory. Raises where F*K >= 2**31 (int32 pair
    indices) and above D = 576 (no strip form fits)."""
    pairs = F * K
    if pairs >= MAX_PAIRS:
        raise ValueError(f"gmm_rescore: F*K = {pairs} pairs, at or above "
                         f"the 2**31 the kernel indexes")
    strip = p_rows(D)
    smem = smem_bytes(D, strip)
    if smem > MAX_SMEM:
        strip = STRIP
        smem = smem_bytes(D, STRIP)
    if smem > MAX_SMEM:
        raise ValueError(f"gmm_rescore: D={D} needs {smem} bytes of shared "
                         f"memory a block, above the {MAX_SMEM} a block may "
                         f"have")
    max_items = -(-pairs // BP) + C
    return Geometry(BP, max_items,
                    _round_up(2 * C + 1, 4) + 4 * max_items + pairs, smem,
                    strip, int(4 * C > MAX_SMEM))


def kernel_geometry(F: int, K: int, C: int, D: int):
    """What ``geometry`` gives, as the CUDA side computes it
    (``gmm_rescore_geometry``), or None where it refuses the shapes."""
    out = (ctypes.c_longlong * 6)()
    err = _build.load("gmm_rescore").gmm_rescore_geometry(
        F, K, C, D, ctypes.addressof(out))
    return None if err else Geometry(*out)


def strip_scores(x, sel, A, strip: int = STRIP):
    """The strip form's sums in plain tensor code: for each (frame, slot)
    pair, q = -2 x.lin + sum over strips of P's rows (in order) of
    x_S' (P_S x), each strip's part added onto the running sum; out =
    const - q / 2. x [F, D], sel [F, K] in [0, C), A [C, E] packed rows
    -> [F, K] f32."""
    F, D = x.shape
    rows = A[sel.reshape(-1)].float()                  # [F K, E]
    xr = x.float().repeat_interleave(sel.shape[1], 0)  # [F K, D]
    P = rows[:, 1 + D:1 + D + D * D].reshape(-1, D, D)
    q = -2.0 * (xr * rows[:, 1:1 + D]).sum(1)
    for i_s in range(0, D, strip):
        Ps = P[:, i_s:i_s + strip]                     # [F K, S, D]
        part = torch.einsum("ps,psj,pj->p", xr[:, i_s:i_s + strip], Ps, xr)
        q = q + part
    return (rows[:, 0] - 0.5 * q).reshape(sel.shape)


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
        g.smem_bytes, g.strip, *_build.launch_args(x))
    _build.check(err, "gmm_rescore")
    gmm_rescore.launches += 1
    if g.strip != p_rows(D):
        gmm_rescore.by_form["strips"] += 1
    if g.hist_global:
        gmm_rescore.by_form["hist_global"] += 1
    return out


gmm_rescore.launches = 0
# launches of the two forms past the first (``geometry``): P in strips,
# the sort's histogram in device memory (a launch may take both)
gmm_rescore.by_form = {"strips": 0, "hist_global": 0}
