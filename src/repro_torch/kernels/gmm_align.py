"""CUDA kernel wrappers: fused alignment (diag preselect, top-K and packed
rescore in one launch), and its rescore alone for a given selection.

Both launch the one kernel of ``csrc/gmm_align.cu`` (which says what it
replaces, what bounds it and how it is laid out); ``gmm_rescore_fused``
hands it the selection instead of letting it choose. The kernel masks
ragged F and C itself. Ids given to ``gmm_rescore_fused`` must lie in
[0, C): ``ops.gmm_rescore_fused`` clips them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _check(name, x, A2, *rest):
    F, D = x.shape
    E2 = A2.shape[1]
    if E2 != 1 + D + D * (D + 1) // 2:
        raise ValueError(f"{name}: A2 {tuple(A2.shape)} is not the packed "
                         f"rows of D={D}")
    _build.require_cuda(name, x, A2, *rest)
    if any(t.dtype != torch.float32 for t in (x, A2, *rest)):
        raise TypeError(f"{name}: the kernel takes float32 operands")
    return F, D, A2.shape[0], E2


def gmm_align(x, dconst, dlin, dquad, A2, top_k: int):
    """x: [F, D]; dconst: [C]; dlin, dquad: [D, C]; A2: [C, E2], f32 on one
    CUDA device -> (sel_ll [F, K] f32, sel [F, K] int64)."""
    F, D, C, E2 = _check("gmm_align", x, A2, dconst, dlin, dquad)
    if dconst.shape != (C,) or dlin.shape != (D, C) or dquad.shape != (D, C):
        raise ValueError(f"gmm_align: diag coefficients {tuple(dconst.shape)}"
                         f", {tuple(dlin.shape)}, {tuple(dquad.shape)} for "
                         f"C={C}, D={D}")
    if not 1 <= top_k <= C:
        raise ValueError(f"gmm_align: top_k={top_k} outside [1, C={C}]")
    ll = torch.empty((F, top_k), dtype=torch.float32, device=x.device)
    sel = torch.empty((F, top_k), dtype=torch.int64, device=x.device)
    err = _build.load("gmm_align").gmm_align_f32(
        x.data_ptr(), dconst.data_ptr(), dlin.data_ptr(), dquad.data_ptr(),
        A2.data_ptr(), ll.data_ptr(), sel.data_ptr(), F, C, D, top_k, E2,
        *_build.launch_args(x))
    _build.check(err, "gmm_align")
    gmm_align.launches += 1
    return ll, sel


def gmm_rescore_fused(x, sel, A2):
    """x: [F, D] f32; sel: [F, K] int64 in [0, C); A2: [C, E2] f32, all on
    one CUDA device -> [F, K] f32 selected log-likelihoods."""
    F, D, C, E2 = _check("gmm_rescore_fused", x, A2)
    _build.require_cuda("gmm_rescore_fused", sel)
    if sel.dtype != torch.int64 or sel.ndim != 2 or sel.shape[0] != F:
        raise ValueError(f"gmm_rescore_fused: sel must be int64 [{F}, K], "
                         f"got {sel.dtype} {tuple(sel.shape)}")
    K = sel.shape[1]
    ll = torch.empty((F, K), dtype=torch.float32, device=x.device)
    err = _build.load("gmm_align").gmm_rescore_fused_f32(
        x.data_ptr(), sel.data_ptr(), A2.data_ptr(), ll.data_ptr(), F, C, D,
        K, E2, *_build.launch_args(x))
    _build.check(err, "gmm_rescore_fused")
    gmm_rescore_fused.launches += 1
    return ll


gmm_align.launches = 0
gmm_rescore_fused.launches = 0
