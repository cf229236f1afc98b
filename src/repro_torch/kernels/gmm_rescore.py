"""CUDA kernel wrapper: sparse gather-and-rescore of the selected components.

Launches ``csrc/gmm_rescore.cu`` on the packed rows of ``ref.rescore_pack``
([C, E] with E >= 1 + D + D*D). Ids must already lie in [0, C):
``ops.gmm_rescore`` clips them, as the contract of the JAX wrapper does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def gmm_rescore(x, sel, A):
    """x: [F, D] f32; sel: [F, K] int64 in [0, C); A: [C, E] f32 packed
    rows, all on one CUDA device -> [F, K] f32 selected log-likelihoods."""
    F, D = x.shape
    K = sel.shape[1]
    E = A.shape[1]
    if sel.shape[0] != F or E < 1 + D + D * D:
        raise ValueError(f"gmm_rescore: shapes x {tuple(x.shape)}, sel "
                         f"{tuple(sel.shape)}, A {tuple(A.shape)}")
    _build.require_cuda("gmm_rescore", x, sel, A)
    if x.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("gmm_rescore: the kernel takes float32 x and A")
    if sel.dtype != torch.int64:
        raise TypeError("gmm_rescore: sel must be int64")
    out = torch.empty((F, K), dtype=torch.float32, device=x.device)
    err = _build.load("gmm_rescore").gmm_rescore_f32(
        x.data_ptr(), sel.data_ptr(), A.data_ptr(), out.data_ptr(),
        F, K, D, E, *_build.launch_args(x))
    _build.check(err, "gmm_rescore")
    gmm_rescore.launches += 1
    return out


gmm_rescore.launches = 0
