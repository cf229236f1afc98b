"""CUDA kernel wrapper: dense full-covariance GMM log-likelihood.

Launches ``csrc/gmm_loglik.cu`` (which says what it replaces, what bounds
it and how it is laid out). The kernel masks ragged F and C itself, so the
wrapper pads nothing. ``ops.gmm_loglik`` dispatches here for CUDA tensors
and to ``ref.gmm_loglik`` for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def gmm_loglik(x, const, lin, P_flat):
    """x: [F, D]; const: [C]; lin: [D, C]; P_flat: [C, D*D], all f32 on
    one CUDA device -> [F, C] f32."""
    F, D = x.shape
    C = const.shape[0]
    if lin.shape != (D, C) or P_flat.shape != (C, D * D):
        raise ValueError(f"gmm_loglik: shapes x {tuple(x.shape)}, lin "
                         f"{tuple(lin.shape)}, P_flat {tuple(P_flat.shape)}")
    _build.require_cuda("gmm_loglik", x, const, lin, P_flat)
    if any(t.dtype != torch.float32 for t in (x, const, lin, P_flat)):
        raise TypeError("gmm_loglik: the kernel takes float32 operands")
    out = torch.empty((F, C), dtype=torch.float32, device=x.device)
    err = _build.load("gmm_loglik").gmm_loglik_f32(
        x.data_ptr(), const.data_ptr(), lin.data_ptr(), P_flat.data_ptr(),
        out.data_ptr(), F, C, D, *_build.launch_args(x))
    _build.check(err, "gmm_loglik")
    gmm_loglik.launches += 1
    return out


gmm_loglik.launches = 0
