"""CUDA kernel wrapper: dense Baum-Welch moments n, f and S.

Launches ``csrc/bw_stats.cu`` (which says what it replaces, what bounds it
and how it is laid out). The kernel masks ragged F and C itself, so the
wrapper pads nothing. ``ops.bw_stats`` dispatches here for CUDA tensors
and to ``ref.bw_stats`` for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def bw_stats(gamma, x):
    """gamma: [F, C]; x: [F, D], f32 on one CUDA device ->
    (n [C], f [C, D], S [C, D*D]) f32."""
    F, C = gamma.shape
    if x.ndim != 2 or x.shape[0] != F:
        raise ValueError(f"bw_stats: shapes gamma {tuple(gamma.shape)}, "
                         f"x {tuple(x.shape)}")
    D = x.shape[1]
    _build.require_cuda("bw_stats", gamma, x)
    if gamma.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("bw_stats: the kernel takes float32 operands")
    n = torch.empty((C,), dtype=torch.float32, device=x.device)
    f = torch.empty((C, D), dtype=torch.float32, device=x.device)
    S = torch.empty((C, D * D), dtype=torch.float32, device=x.device)
    err = _build.load("bw_stats").bw_stats_f32(
        gamma.data_ptr(), x.data_ptr(), n.data_ptr(), f.data_ptr(),
        S.data_ptr(), F, C, D, *_build.launch_args(x))
    _build.check(err, "bw_stats")
    bw_stats.launches += 1
    return n, f, S


bw_stats.launches = 0
