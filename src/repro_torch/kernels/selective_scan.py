"""CUDA kernel wrappers: the Mamba selective scan, forward and backward.

Launches ``csrc/selective_scan.cu`` (which says what it replaces, what
bounds it and how it is laid out). Unlike the TPU kernel it takes an
optional initial state h0 and returns the last state, so one kernel
serves both prefill and a decode step; with ``save_states`` it also
returns the state at the start of every BT-step chunk, from which the
backward kernels (``selective_scan_bwd``) recompute each chunk's states,
in segments of SEG_CHUNKS chunks that run in parallel over time.
``ops.selective_scan`` dispatches here for CUDA tensors (through an
autograd function when a gradient is wanted) and to
``ref.selective_scan`` for CPU tensors; ``scan_lanes`` is the forward
kernel's arithmetic and ``backward_chunks`` the backward kernels'
algorithm, in plain tensor code.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# the d_states the kernel has an instance for
D_STATES = (4, 8, 16, 32, 64)
# the d_states the backward kernel has an instance for (a block is ds / 4
# lanes a channel: 512 threads at 32)
BWD_D_STATES = (4, 8, 16, 32)
# csrc/selective_scan.cu: log2(e), folded into A once; channels a block,
# time steps a chunk, chunks in flight (forward and backward); states a
# lane in the backward (namespace bwd: SL)
LOG2E = 1.4426950408889634
CH = 64
BT = 16
STAGES = 3
BWD_STATES_PER_LANE = 4
# chunks a segment of the backward: T is cut into segments of this many
# 16-step chunks, whose adjoints run in parallel (8 segments at T = 4096;
# chip_smoke.py phase 13 sweeps it on the card)
SEG_CHUNKS = 32


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


def bwd_lanes(ds: int) -> int:
    """Lanes a channel in the backward kernels (``bwd::blanes``): ds / 4,
    each with 4 consecutive states."""
    return ds // BWD_STATES_PER_LANE


def bwd_smem_bytes(ds: int) -> int:
    """Shared memory of a block of the backward's gradient pass
    (``bwd::smem_floats``): a ring of STAGES chunks' dt, dx, dy, Bc, Cc and
    start states, then d(dx) and d(dt) and the warps' dB and dC sums."""
    stage = 3 * BT * CH + 2 * BT * ds + CH * ds
    return 4 * (STAGES * stage + 2 * BT * CH
                + 2 * (CH * bwd_lanes(ds) // 32) * BT * ds)


def n_chunks(T: int) -> int:
    return -(-T // BT)


def n_segments(T: int, seg_chunks: int = None) -> int:
    """Segments of the backward: ceil(chunks / seg_chunks)."""
    return -(-n_chunks(T) // (seg_chunks or SEG_CHUNKS))


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


def selective_scan(dt, dx, A, Bc, Cc, h0=None, save_states: bool = False):
    """dt, dx: [B, T, di]; A: [di, ds]; Bc, Cc: [B, T, ds]; h0: [B, di, ds]
    or None (zeros); all float32, contiguous, on one CUDA device, with
    ds in D_STATES -> (y [B, T, di], h_last [B, di, ds]) float32, and with
    ``save_states`` also hs [B, n_chunks(T), di, ds], the state at the
    start of each BT-step chunk (hs[:, 0] is h0)."""
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
    hs = (torch.empty((B, n_chunks(T), di, ds), dtype=torch.float32,
                      device=dt.device) if save_states else None)
    err = _build.load("selective_scan").selective_scan_f32(
        dt.data_ptr(), dx.data_ptr(), A.data_ptr(), Bc.data_ptr(),
        Cc.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), None if hs is None else hs.data_ptr(), B, T, di,
        ds, *_build.launch_args(dt))
    _build.check(err, "selective_scan")
    selective_scan.launches += 1
    return (y, h_last, hs) if save_states else (y, h_last)


selective_scan.launches = 0


def selective_scan_bwd(dt, dx, A, Bc, Cc, hs, dy, dh_last=None,
                       want_dh0: bool = False):
    """The gradients of ``selective_scan``: its inputs, hs from its
    ``save_states``, dy [B, T, di] the gradient of y and dh_last
    [B, di, ds] (or None: zero) that of h_last; all float32, contiguous,
    on one CUDA device, ds in BWD_D_STATES -> (d(dt), d(dx), dA, dB, dC,
    dh0 or None). dA, dB and dC are sums over di (and dA over B and T),
    formed as per-block partials added in a fixed order: the same bits
    every run. T is cut into segments of SEG_CHUNKS chunks, run in
    parallel; the carries between them are composed in a fixed order."""
    B, T, di = dt.shape
    ds = A.shape[1]
    if ds not in BWD_D_STATES:
        raise ValueError(f"selective_scan_bwd: the backward kernel has "
                         f"instances for d_state in {BWD_D_STATES}, not {ds}")
    if (dx.shape != dt.shape or dy.shape != dt.shape or A.shape != (di, ds)
            or Bc.shape != (B, T, ds) or Cc.shape != Bc.shape
            or hs.shape != (B, n_chunks(T), di, ds)
            or (dh_last is not None and dh_last.shape != (B, di, ds))):
        raise ValueError(
            f"selective_scan_bwd: shapes dt {tuple(dt.shape)}, dx "
            f"{tuple(dx.shape)}, A {tuple(A.shape)}, Bc {tuple(Bc.shape)}, "
            f"Cc {tuple(Cc.shape)}, hs {tuple(hs.shape)}, dy "
            f"{tuple(dy.shape)}")
    ops = (dt, dx, A, Bc, Cc, hs, dy) + (() if dh_last is None
                                         else (dh_last,))
    _build.require_cuda("selective_scan_bwd", *ops)
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError("selective_scan_bwd: the kernel takes float32 "
                        "operands")
    dt, dx, A, Bc, Cc, hs, dy = (_build.aligned(t)
                                 for t in (dt, dx, A, Bc, Cc, hs, dy))
    if dh_last is not None:
        dh_last = _build.aligned(dh_last)
    f32, dev = torch.float32, dt.device
    nblk, nseg = -(-di // CH), n_segments(T)
    ddt, ddx = torch.empty_like(dt), torch.empty_like(dx)
    lcarry, decay, dA_part = (torch.empty((B, nseg, di, ds), dtype=f32,
                                          device=dev) for _ in range(3))
    dB_part = torch.empty((B, nblk, T, ds), dtype=f32, device=dev)
    dC_part = torch.empty_like(dB_part)
    dA = torch.empty((di, ds), dtype=f32, device=dev)
    dB, dC = torch.empty_like(Bc), torch.empty_like(Cc)
    dh0 = torch.empty((B, di, ds), dtype=f32, device=dev) if want_dh0 \
        else None
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    err = _build.load("selective_scan").selective_scan_bwd_f32(
        *(ptr(t) for t in (dt, dx, A, Bc, Cc, hs, dy, dh_last, ddt, ddx,
                           lcarry, decay, dA_part, dB_part, dC_part, dA, dB,
                           dC, dh0)),
        B, T, di, ds, SEG_CHUNKS, *_build.launch_args(dt))
    _build.check(err, "selective_scan_bwd")
    selective_scan_bwd.launches += 1
    return ddt, ddx, dA, dB, dC, dh0


selective_scan_bwd.launches = 0


def backward_chunks(dt, dx, A, Bc, Cc, dy, h0=None, dh_last=None,
                    seg_chunks: int = SEG_CHUNKS):
    """The backward kernels' algorithm in plain tensor code (the CPU tests
    hold it against autograd of ``ref.selective_scan``). The forward keeps
    the state at the start of each BT-step chunk; T is cut into segments
    of ``seg_chunks`` chunks. Pass 1: each segment but the first runs the
    adjoint g_t = dy_t C_t + a_{t+1} g_{t+1} back from a zero carry, giving
    the carry L it leaves and the product P of its decays
    a_t = exp2(dt_t (A log2 e)). Pass 2: the carry into each segment's last
    step, last segment first: K = dh_last (or 0), K_{s-1} = P_s K_s + L_s.
    Pass 3: each segment from its carry, its chunks last to first, each
    chunk's states recomputed from its start and the adjoint run back
    through it. dA is summed per (batch row, segment), then over those in
    order. Returns (d(dt), d(dx), dA, dB, dC, dh0), dh0 None without h0."""
    B, T, di = dt.shape
    ds = A.shape[1]
    f32 = torch.float32
    dt, dx, Bc, Cc, dy = (t.to(f32) for t in (dt, dx, Bc, Cc, dy))
    A = A.to(f32)
    a2 = A * torch.tensor(LOG2E, dtype=f32)

    def decay(t):
        return torch.exp2(dt[:, t, :, None] * a2)

    h = (torch.zeros((B, di, ds), dtype=f32, device=dt.device)
         if h0 is None else h0.to(f32))
    starts = []
    for t in range(T):
        if t % BT == 0:
            starts.append(h)
        h = decay(t) * h + dx[:, t, :, None] * Bc[:, t, None, :]
    nseg = n_segments(T, seg_chunks)
    span = [(s * seg_chunks, min(len(starts), (s + 1) * seg_chunks))
            for s in range(nseg)]                         # chunks [c0, c1)
    lc, pc = {}, {}
    for s in range(1, nseg):                              # pass 1
        carry, prod = torch.zeros_like(h), torch.ones_like(h)
        for t in reversed(range(span[s][0] * BT, min(T, span[s][1] * BT))):
            at = decay(t)
            carry = at * (dy[:, t, :, None] * Cc[:, t, None, :] + carry)
            prod = prod * at
        lc[s], pc[s] = carry, prod
    k = torch.zeros_like(h) if dh_last is None else dh_last.to(f32)
    kin = [None] * nseg                                   # pass 2
    for s in range(nseg - 1, 0, -1):
        kin[s] = k
        k = pc[s] * k + lc[s]
    kin[0] = k
    ddt, ddx = torch.zeros_like(dt), torch.zeros_like(dx)
    dA_parts = torch.zeros((B, nseg, di, ds), dtype=f32, device=dt.device)
    dB, dC = torch.zeros_like(Bc), torch.zeros_like(Cc)
    for s in range(nseg):                                 # pass 3
        carry = kin[s]
        for c in reversed(range(*span[s])):
            t0, t1 = c * BT, min(T, (c + 1) * BT)
            h, prev = starts[c], []
            for t in range(t0, t1):
                prev.append(h)
                h = decay(t) * h + dx[:, t, :, None] * Bc[:, t, None, :]
                dC[:, t] = (dy[:, t, :, None] * h).sum(1)
            for t in reversed(range(t0, t1)):
                at = decay(t)
                g = dy[:, t, :, None] * Cc[:, t, None, :] + carry
                ddx[:, t] = (g * Bc[:, t, None, :]).sum(-1)
                w = g * at * prev[t - t0]
                ddt[:, t] = (w * A).sum(-1)
                dA_parts[:, s] += w * dt[:, t, :, None]
                dB[:, t] = (g * dx[:, t, :, None]).sum(1)
                carry = at * g
        if s == 0:
            dh0 = carry
    dA = dA_parts[0, 0].clone()
    for p in dA_parts.reshape(B * nseg, di, ds)[1:]:      # in index order
        dA = dA + p
    return ddt, ddx, dA, dB, dC, None if h0 is None else dh0
