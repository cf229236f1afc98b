"""CUDA kernel wrapper: the Mamba selective scan.

Launches ``csrc/selective_scan.cu`` (which says what it replaces, what
bounds it and how it is laid out). Unlike the TPU kernel it takes an
optional initial state h0 and returns the last state, so one kernel
serves both prefill and a decode step. ``ops.selective_scan`` dispatches
here for CUDA tensors and to ``ref.selective_scan`` for CPU tensors;
``scan_lanes`` is the kernel's arithmetic in plain tensor code.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# the d_states the kernel has an instance for
D_STATES = (4, 8, 16, 32, 64)
# csrc/selective_scan.cu: log2(e), folded into A once; channels a block,
# time steps a chunk, chunks in flight
LOG2E = 1.4426950408889634
CH = 64
BT = 16
STAGES = 3


def lanes(ds: int) -> int:
    """Lanes of a warp that share one channel's states (``lanes`` in
    csrc/selective_scan.cu): two, each with half the states; one at ds = 4
    and four from ds = 32 on, so that a lane holds 4 to 16 states."""
    if ds not in D_STATES:
        raise ValueError(f"selective_scan: the kernel has instances for "
                         f"d_state in {D_STATES}, not {ds}")
    return 1 if ds == 4 else 2 if ds <= 16 else 4


def smem_bytes(ds: int) -> int:
    """Shared memory of a block (``smem_floats`` in
    csrc/selective_scan.cu): a chunk's dt, dx, Bc and Cc a stage, then its
    y."""
    return 4 * (STAGES * BT * (2 * CH + 2 * ds) + BT * CH)


def scan_lanes(dt, dx, A, Bc, Cc, h0=None):
    """The kernel's function in plain tensor code, in its order: the decay
    exp2(dt (A log2 e)); each lane's partial sum of C_s h_s over its
    ``ds / lanes(ds)`` consecutive states, ascending; the lanes' partials
    added as the xor shuffles add them (lanes 1 apart, then 2 apart).
    Same arguments and result as ``ref.selective_scan``."""
    B, T, di = dt.shape
    ds = A.shape[1]
    L = lanes(ds)
    f32 = torch.float32
    dt, dx, Bc, Cc = (t.to(f32) for t in (dt, dx, Bc, Cc))
    a2 = A.to(f32) * torch.tensor(LOG2E, dtype=f32)
    h = (torch.zeros((B, di, ds), dtype=f32, device=dt.device)
         if h0 is None else h0.to(f32))
    y = torch.empty((B, T, di), dtype=f32, device=dt.device)
    for t in range(T):
        h = (torch.exp2(dt[:, t, :, None] * a2) * h
             + dx[:, t, :, None] * Bc[:, t, None, :])
        prod = (h * Cc[:, t, None, :]).reshape(B, di, L, ds // L)
        p = prod[..., 0]
        for s in range(1, ds // L):
            p = p + prod[..., s]
        while p.shape[-1] > 1:
            p = p[..., 0::2] + p[..., 1::2]
        y[:, t] = p[..., 0]
    return y, h


def selective_scan(dt, dx, A, Bc, Cc, h0=None):
    """dt, dx: [B, T, di]; A: [di, ds]; Bc, Cc: [B, T, ds]; h0: [B, di, ds]
    or None (zeros); all float32, contiguous, on one CUDA device, with
    ds in D_STATES -> (y [B, T, di], h_last [B, di, ds]) float32."""
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
    lanes(ds)   # raises on a d_state without an instance
    ops = (dt, dx, A, Bc, Cc) + (() if h0 is None else (h0,))
    _build.require_cuda("selective_scan", *ops)
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError("selective_scan: the kernel takes float32 operands")
    dt, dx, A, Bc, Cc = (_build.aligned(t) for t in (dt, dx, A, Bc, Cc))
    if h0 is not None:
        h0 = _build.aligned(h0)
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
