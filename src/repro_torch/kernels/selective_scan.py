"""CUDA kernel wrapper: the Mamba selective scan.

Launches ``csrc/selective_scan.cu`` (which says what it replaces, what
bounds it and how it is laid out). Unlike the TPU kernel it takes an
optional initial state h0 and returns the last state, so one kernel
serves both prefill and a decode step. ``ops.selective_scan`` dispatches
here for CUDA tensors and to ``ref.selective_scan`` for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

D_STATE = 16    # the one d_state the kernel is built for (Jamba's)


def selective_scan(dt, dx, A, Bc, Cc, h0=None):
    """dt, dx: [B, T, di]; A: [di, ds]; Bc, Cc: [B, T, ds]; h0: [B, di, ds]
    or None (zeros); all float32, contiguous, on one CUDA device, with
    ds = 16 -> (y [B, T, di], h_last [B, di, ds]) float32."""
    B, T, di = dt.shape
    ds = A.shape[1]
    if (dx.shape != dt.shape or A.shape != (di, ds)
            or Bc.shape != (B, T, ds) or Cc.shape != Bc.shape
            or (h0 is not None and h0.shape != (B, di, ds))):
        raise ValueError(
            f"selective_scan: shapes dt {tuple(dt.shape)}, dx "
            f"{tuple(dx.shape)}, A {tuple(A.shape)}, Bc {tuple(Bc.shape)}, "
            f"Cc {tuple(Cc.shape)}, h0 "
            f"{None if h0 is None else tuple(h0.shape)}")
    if ds != D_STATE:
        raise ValueError(f"selective_scan: the kernel is built for d_state "
                         f"{D_STATE}, not {ds}")
    ops = (dt, dx, A, Bc, Cc) + (() if h0 is None else (h0,))
    _build.require_cuda("selective_scan", *ops)
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError("selective_scan: the kernel takes float32 operands")
    y = torch.empty((B, T, di), dtype=torch.float32, device=dt.device)
    h_last = torch.empty((B, di, ds), dtype=torch.float32, device=dt.device)
    err = _build.load("selective_scan").selective_scan_f32(
        dt.data_ptr(), dx.data_ptr(), A.data_ptr(), Bc.data_ptr(),
        Cc.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), B, T, di, ds, *_build.launch_args(dt))
    _build.check(err, "selective_scan")
    selective_scan.launches += 1
    return y, h_last


selective_scan.launches = 0
