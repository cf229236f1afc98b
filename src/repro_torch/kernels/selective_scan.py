"""CUDA kernel wrappers: the Mamba selective scan, forward and backward.

Launches ``csrc/selective_scan.cu`` and, for the gradients,
``csrc/selective_scan_bwd.cu`` (which say what they replace, what bounds
them and how they are laid out). Unlike the TPU kernel it takes an
optional initial state h0 and returns the last state, so one kernel
serves both prefill and a decode step; with ``save_states`` it also
returns the state at the start of every BT-step chunk, from which the
backward kernels (``selective_scan_bwd``) recompute each chunk's states,
in segments of SEG_CHUNKS chunks that run in parallel over time.
``scan_dtype`` picks the form: "float32" the f32 scan, "bfloat16" and
"float16" the reference's chunked tree with its transitions rounded to
that type (namespace tree; its backward takes the recurrence in f32 at
the rounded transitions). Any d_state from 1 to 64 runs the instance
``instance(ds)``, the states above it masked in the kernel; from 65 to
256 (``D_STATES``) the states are cut into ``groups(ds)`` groups of 64,
a grid axis, each running the 64-state instance on its own states, and
the groups' partial sums over the states (y forward, d(dx) and d(dt)
backward) are added in group order by a second kernel. Past 256 the
wrappers raise.
``ops.selective_scan`` dispatches here for CUDA tensors (through an
autograd function when a gradient is wanted) and to
``ref.selective_scan`` for CPU tensors; ``scan_lanes`` and
``scan_tree_lanes`` are the forward kernels' arithmetic and
``backward_chunks`` the backward kernels' algorithm, in plain tensor
code.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# the d_state instances of csrc/selective_scan.cu; every d_state from 1 to
# 64 runs the least instance at or above it (``instance``), forward and
# backward (a block of the backward is ds / 4 lanes a channel: 512
# threads from ds = 32 on, 32 channels a block at 64); from 65 to 256 the
# 64-state instance once for each group of GROUP states (``groups``)
INSTANCES = (4, 8, 16, 32, 64)
GROUP = 64
D_STATES = tuple(range(1, 257))
BWD_D_STATES = D_STATES
# the entry points' form by scan_dtype: the transitions' type
FORMS = {"float32": 0, "bfloat16": 1, "float16": 2}
# csrc/selective_scan.cuh: log2(e), folded into A once; channels a block,
# time steps a chunk; chunks in flight (STAGES, forward and backward);
# states a lane in the backward (csrc/selective_scan_bwd.cu, namespace
# bwd: SL)
LOG2E = 1.4426950408889634
CH = 64
BT = 16
STAGES = 3
BWD_STATES_PER_LANE = 4
# the tree forward (namespace tree): states a lane, steps a group (the
# reference's chunk, ref.SSM_CHUNK) and threads a block from ds = 32 on
TREE_STATES_PER_LANE = 4
TREE_GROUP = 64
TREE_THREADS = 256
# chunks a segment of the backward: T is cut into segments of this many
# 16-step chunks, whose adjoints run in parallel (8 segments at T = 4096;
# chip_smoke.py phase 13 sweeps it on the card)
SEG_CHUNKS = 32


def instance(ds: int) -> int:
    """The d_state instance a d_state runs (``instance`` in
    csrc/selective_scan.cuh): the least of INSTANCES at or above it, the
    states above ds masked; past 64 the 64-state instance (one a group).
    Raises past 256."""
    if ds not in D_STATES:
        raise ValueError(f"selective_scan: the kernel takes d_state 1 to "
                         f"{D_STATES[-1]}, not {ds}")
    return next((n for n in INSTANCES if n >= ds), GROUP)


def groups(ds: int) -> int:
    """The groups of up to GROUP states a d_state is cut into (``groups``
    in csrc/selective_scan.cuh): a grid axis of both launches, 1 up to
    64."""
    instance(ds)
    return -(-ds // GROUP)


def width(ds: int) -> int:
    """States a row of the backward's scratch (carries, decays, the dA, dB
    and dC partials): the instance's, times the groups."""
    return instance(ds) * groups(ds)


def _group_slices(ds: int):
    """The state slices of the groups, in order."""
    return [slice(s, min(s + GROUP, ds)) for s in range(0, ds, GROUP)]


def form(scan_dtype: str) -> int:
    """The entry points' form for a scan_dtype name (FORMS)."""
    ref.scan_type(scan_dtype)        # raises on other names
    return FORMS[scan_dtype]


def lanes(ds: int) -> int:
    """Lanes of a warp that share one channel's states in the f32 forward
    (``lanes`` in csrc/selective_scan.cu, of ds's instance): two, each
    with half the states; one at ds = 4 and four from ds = 32 on, so that
    a lane holds 4 to 16 states."""
    n = instance(ds)
    return 1 if n == 4 else 2 if n <= 16 else 4


def tree_lanes(ds: int) -> int:
    """Lanes a channel in the tree forward (``tree::tlanes``): 4 states
    each."""
    return instance(ds) // TREE_STATES_PER_LANE


def tree_channels(ds: int) -> int:
    """Channels a block of the tree forward (``tree::tch``): CH, or
    TREE_THREADS' worth of lanes from ds = 32 on."""
    L = tree_lanes(ds)
    return CH if L <= 4 else TREE_THREADS // L


def geometry(ds: int) -> tuple:
    """(instance, groups, tree lanes, tree channels, tree shared memory) of
    a d_state's forward: what ``selective_scan_geometry`` of
    csrc/selective_scan.cu gives."""
    return (instance(ds), groups(ds), tree_lanes(ds), tree_channels(ds),
            smem_bytes(ds, "bfloat16"))


def bwd_geometry(ds: int) -> tuple:
    """(instance, groups, lanes a channel, channels a block, shared memory
    of the gradient pass) of a d_state's backward: what
    ``selective_scan_bwd_geometry`` of csrc/selective_scan_bwd.cu gives."""
    return (instance(ds), groups(ds), bwd_lanes(ds), bwd_channels(ds),
            bwd_smem_bytes(ds))


def kernel_geometry(ds: int, backward: bool = False):
    """``geometry`` (or ``bwd_geometry``) as the CUDA side computes it, or
    None where it refuses the d_state; needs the built library."""
    import ctypes
    name = "selective_scan_bwd" if backward else "selective_scan"
    out = (ctypes.c_int * 5)()
    err = getattr(_build.load(name), f"{name}_geometry")(ds, out)
    return None if err else tuple(out)


def smem_bytes(ds: int, scan_dtype: str = "float32") -> int:
    """Shared memory of a block (``smem_floats`` and ``tree::smem_floats``
    in csrc/selective_scan.cu): a chunk's dt, dx, Bc and Cc a stage, then
    its y."""
    n = instance(ds)
    ch = CH if form(scan_dtype) == 0 else tree_channels(ds)
    return 4 * (STAGES * BT * (2 * ch + 2 * n) + BT * ch)


def bwd_lanes(ds: int) -> int:
    """Lanes a channel in the backward kernels (``bwd::blanes``): ds / 4
    of the instance, each with 4 consecutive states."""
    return instance(ds) // BWD_STATES_PER_LANE


def bwd_channels(ds: int) -> int:
    """Channels a block of the backward (``bwd::bch``): CH, and CH / 2 at
    the 64-state instance, where a channel is 16 lanes: 512 threads a
    block, so that a thread keeps the 128 registers its chunk's 16 x 4
    states need."""
    return CH if instance(ds) <= 32 else CH // 2


def bwd_smem_bytes(ds: int) -> int:
    """Shared memory of a block of the backward's gradient pass
    (``bwd::smem_floats``): a ring of STAGES chunks' dt, dx, dy, Bc, Cc and
    start states, then d(dx) and d(dt) and the warps' dB and dC sums."""
    n, ch = instance(ds), bwd_channels(ds)
    stage = 3 * BT * ch + 2 * BT * n + ch * n
    return 4 * (STAGES * stage + 2 * BT * ch
                + 2 * (ch * bwd_lanes(ds) // 32) * BT * n)


def n_chunks(T: int) -> int:
    return -(-T // BT)


def n_segments(T: int, seg_chunks: int = None) -> int:
    """Segments of the backward: ceil(chunks / seg_chunks)."""
    return -(-n_chunks(T) // (seg_chunks or SEG_CHUNKS))


def _padded(n, A, Bc, Cc, h0):
    """A, Bc, Cc and h0 with their states padded by zeros to n, as the
    kernel masks the states of its instance past ds (A = B = C = h0 = 0:
    such a state stays 0 and adds exact zeros)."""
    pad = n - A.shape[1]
    if pad == 0:
        return A, Bc, Cc, h0
    z = torch.nn.functional.pad
    return (z(A, (0, pad)), z(Bc, (0, pad)), z(Cc, (0, pad)),
            None if h0 is None else z(h0, (0, pad)))


def _lane_sum(prod, L: int):
    """y from the [B, di, n] products of a step: each lane's partial over
    its n / L consecutive states in ascending order, then the lanes'
    partials added in adjacent pairs (lanes 1 apart, then 2, ..), as the
    kernels' shuffles add them."""
    B, di, n = prod.shape
    prod = prod.reshape(B, di, L, n // L)
    p = prod[..., 0]
    for s in range(1, n // L):
        p = p + prod[..., s]
    while p.shape[-1] > 1:
        p = p[..., 0::2] + p[..., 1::2]
    return p[..., 0]


def _by_groups(fn, dt, dx, A, Bc, Cc, h0, **kw):
    """``fn`` (a forward's function on one group, padded to its instance)
    over the state groups: y the groups' partials added in group order, as
    sum_groups_kernel adds them, and h_last their states side by side."""
    y, hs = None, []
    for sl in _group_slices(A.shape[1]):
        yg, hg = fn(dt, dx, A[:, sl], Bc[..., sl], Cc[..., sl],
                    None if h0 is None else h0[..., sl], **kw)
        y = yg if y is None else y + yg
        hs.append(hg)
    return y, torch.cat(hs, -1)


def scan_lanes(dt, dx, A, Bc, Cc, h0=None):
    """The f32 kernel's function in plain tensor code, in its order: the
    decay exp2(dt (A log2 e)); each lane's partial sum of C_s h_s over its
    ``ds / lanes(ds)`` consecutive states, ascending; the lanes' partials
    added as the xor shuffles add them (lanes 1 apart, then 2 apart); the
    states of the instance past ds zero; past 64 states each group of 64
    so, and the groups' partial y added in group order. Same arguments and
    result as ``ref.selective_scan``."""
    ds = A.shape[1]
    return _by_groups(_scan_lanes_group, dt, dx, A, Bc, Cc, h0,
                      n=instance(ds), L=lanes(ds))


def _scan_lanes_group(dt, dx, A, Bc, Cc, h0, n, L):
    B, T, di = dt.shape
    ds = A.shape[1]
    f32 = torch.float32
    A, Bc, Cc, h0 = _padded(n, A, Bc, Cc, h0)
    dt, dx, Bc, Cc = (t.to(f32) for t in (dt, dx, Bc, Cc))
    a2 = A.to(f32) * torch.tensor(LOG2E, dtype=f32)
    h = (torch.zeros((B, di, n), dtype=f32, device=dt.device)
         if h0 is None else h0.to(f32))
    y = torch.empty((B, T, di), dtype=f32, device=dt.device)
    for t in range(T):
        h = (torch.exp2(dt[:, t, :, None] * a2) * h
             + dx[:, t, :, None] * Bc[:, t, None, :])
        y[:, t] = _lane_sum(h * Cc[:, t, None, :], L)
    return y, h[..., :ds]


def scan_tree_lanes(dt, dx, A, Bc, Cc, h0=None, scan_dtype="bfloat16"):
    """The tree kernel's function in plain tensor code, in its order (the
    CPU tests hold it against ``ref.selective_scan_tree`` and the
    reference): per step the element (R(exp(dt A)), R(dx B)) joins a
    binary counter of blocks, merged with the full blocks below the
    step's lowest zero bit, and the prefix is the fold of the next block
    above with it; per group of TREE_GROUP steps six low slots, and at a
    ragged T (one chunk) a high counter of whole groups whose fold leads
    the next group's. h_t = f32(A_t) h + f32(B_t) from the chunk's start
    state; y_t the lanes' partials of R(h_t) R(C_t) (4 states a lane,
    ``_lane_sum``). Same arguments and result as ``ref.selective_scan``
    at that scan_dtype; past 64 states each group of 64 so, and the
    groups' partial y added in group order."""
    ds = A.shape[1]
    return _by_groups(_scan_tree_group, dt, dx, A, Bc, Cc, h0,
                      n=instance(ds), L=tree_lanes(ds),
                      scan_dtype=scan_dtype)


def _scan_tree_group(dt, dx, A, Bc, Cc, h0, n, L, scan_dtype):
    B, T, di = dt.shape
    ds = A.shape[1]
    f32, sd = torch.float32, ref.scan_type(scan_dtype)
    A, Bc, Cc, h0 = _padded(n, A, Bc, Cc, h0)
    dt, dx, A, Bc, Cc = (t.to(f32) for t in (dt, dx, A, Bc, Cc))
    h = (torch.zeros((B, di, n), dtype=f32, device=dt.device)
         if h0 is None else h0.to(f32))
    ragged = T % TREE_GROUP != 0
    low, high, fold_low, fold_high = {}, {}, {}, {}
    y = torch.empty((B, T, di), dtype=f32, device=dt.device)
    hst = h
    for t in range(T):
        g, u = divmod(t, TREE_GROUP)
        if u == 0 and not ragged:
            hst = h                          # a new chunk
        x = (torch.exp(dt[:, t, :, None] * A).to(sd),
             (dx[:, t, :, None] * Bc[:, t, None, :]).to(sd))
        k = 0
        while k < 6 and (u >> k) & 1:
            x = ref.combine(*low[k], *x)
            k += 1
        if k < 6:                            # within the group
            above = [j for j in range(k + 1, 6) if ((u + 1) >> j) & 1]
            if above:
                P = ref.combine(*fold_low[above[0]], *x)
            elif ragged and g > 0:
                P = ref.combine(*H, *x)
            else:
                P = x
            low[k], fold_low[k] = x, P
        elif not ragged:                     # the chunk's last step
            P = x
        else:                                # the group joins the high slots
            k = 0
            while (g >> k) & 1:
                x = ref.combine(*high[k], *x)
                k += 1
            above = [j for j in range(k + 1, 27) if ((g + 1) >> j) & 1]
            P = ref.combine(*fold_high[above[0]], *x) if above else x
            high[k], fold_high[k] = x, P
            H = P
        h = P[0].to(f32) * hst + P[1].to(f32)
        y[:, t] = _lane_sum(h.to(sd).to(f32)
                            * Cc[:, t, None, :].to(sd).to(f32), L)
    return y, h[..., :ds]


def selective_scan(dt, dx, A, Bc, Cc, h0=None, save_states: bool = False,
                   scan_dtype: str = "float32"):
    """dt, dx: [B, T, di]; A: [di, ds]; Bc, Cc: [B, T, ds]; h0: [B, di, ds]
    or None (zeros); all float32, contiguous, on one CUDA device, with
    ds in D_STATES -> (y [B, T, di], h_last [B, di, ds]) float32, and with
    ``save_states`` also hs [B, n_chunks(T), di, ds], the state at the
    start of each BT-step chunk (hs[:, 0] is h0). ``scan_dtype`` (FORMS)
    picks the f32 scan or the rounded tree. Past 64 states the first
    group's partial y goes to y and the others' to a [groups - 1, B, T,
    di] f32 scratch allocated here and freed on return, added into y in
    group order. Launches are counted
    in ``launches``, by scan_dtype in ``by_form`` and, past 64 states, in
    ``by_form_grouped``."""
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
    ng = groups(ds)   # raises on a d_state past 256
    fm = form(scan_dtype)
    if fm and T >= TREE_GROUP << 20:
        raise ValueError(f"selective_scan: the tree's high counter takes "
                         f"T < {TREE_GROUP << 20}, not {T}")
    ops = (dt, dx, A, Bc, Cc) + (() if h0 is None else (h0,))
    _build.require_cuda("selective_scan", *ops)
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError("selective_scan: the kernel takes float32 operands")
    dt, dx, A, Bc, Cc = (_build.aligned(t) for t in (dt, dx, A, Bc, Cc))
    if h0 is not None:
        h0 = _build.aligned(h0)
    y = torch.empty((B, T, di), dtype=torch.float32, device=dt.device)
    parts = (torch.empty((ng - 1, B, T, di), dtype=torch.float32,
                         device=dt.device) if ng > 1 else None)
    h_last = torch.empty((B, di, ds), dtype=torch.float32, device=dt.device)
    hs = (torch.empty((B, n_chunks(T), di, ds), dtype=torch.float32,
                      device=dt.device) if save_states else None)
    err = _build.load("selective_scan").selective_scan_f32(
        dt.data_ptr(), dx.data_ptr(), A.data_ptr(), Bc.data_ptr(),
        Cc.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        None if parts is None else parts.data_ptr(), h_last.data_ptr(), None if hs is None else hs.data_ptr(), B, T, di,
        ds, fm, *_build.launch_args(dt))
    _build.check(err, "selective_scan")
    selective_scan.launches += 1
    selective_scan.by_form[scan_dtype] += 1
    if ng > 1:
        selective_scan.by_form_grouped[scan_dtype] += 1
    return (y, h_last, hs) if save_states else (y, h_last)


def reset_counts() -> None:
    """Both wrappers' launch counts to 0, by form (and past 64 states by
    form) too."""
    for w in (selective_scan, selective_scan_bwd):
        w.launches = 0
        w.by_form = dict.fromkeys(FORMS, 0)
        w.by_form_grouped = dict.fromkeys(FORMS, 0)


def selective_scan_bwd(dt, dx, A, Bc, Cc, hs, dy, dh_last=None,
                       want_dh0: bool = False, scan_dtype: str = "float32"):
    """The gradients of ``selective_scan``: its inputs, hs from its
    ``save_states``, dy [B, T, di] the gradient of y and dh_last
    [B, di, ds] (or None: zero) that of h_last; all float32, contiguous,
    on one CUDA device, ds in BWD_D_STATES -> (d(dt), d(dx), dA, dB, dC,
    dh0 or None). dA, dB and dC are sums over di (and dA over B and T),
    formed as per-block partials added in a fixed order: the same bits
    every run. T is cut into segments of SEG_CHUNKS chunks, run in
    parallel; the carries between them are composed in a fixed order. At a
    16-bit ``scan_dtype`` the gradients are those of the recurrence in f32
    at the tree's rounded transitions, each rounding passing its
    cotangent through (``backward_chunks``). Past 64 states the first
    group's partial d(dt) and d(dx) go to the outputs and the others' to a
    [groups - 1, 2, B, T, di] f32 scratch allocated here and freed on
    return, added into the outputs in group order."""
    B, T, di = dt.shape
    ds = A.shape[1]
    if ds not in BWD_D_STATES:
        raise ValueError(f"selective_scan_bwd: the backward kernel takes "
                         f"d_state 1 to {BWD_D_STATES[-1]}, not {ds}")
    fm = form(scan_dtype)
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
    n, ng = width(ds), groups(ds)
    nblk, nseg = -(-di // bwd_channels(ds)), n_segments(T)
    ddt, ddx = torch.empty_like(dt), torch.empty_like(dx)
    parts = (torch.empty((ng - 1, 2, B, T, di), dtype=f32, device=dev)
             if ng > 1 else None)
    lcarry, decay, dA_part = (torch.empty((B, nseg, di, n), dtype=f32,
                                          device=dev) for _ in range(3))
    dB_part = torch.empty((B, nblk, T, n), dtype=f32, device=dev)
    dC_part = torch.empty_like(dB_part)
    dA = torch.empty((di, ds), dtype=f32, device=dev)
    dB, dC = torch.empty_like(Bc), torch.empty_like(Cc)
    dh0 = torch.empty((B, di, ds), dtype=f32, device=dev) if want_dh0 \
        else None
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    err = _build.load("selective_scan_bwd").selective_scan_bwd_f32(
        *(ptr(t) for t in (dt, dx, A, Bc, Cc, hs, dy, dh_last, ddt, ddx,
                           parts, lcarry, decay, dA_part, dB_part, dC_part,
                           dA, dB, dC, dh0)),
        B, T, di, ds, SEG_CHUNKS, fm, *_build.launch_args(dt))
    _build.check(err, "selective_scan_bwd")
    selective_scan_bwd.launches += 1
    selective_scan_bwd.by_form[scan_dtype] += 1
    if ng > 1:
        selective_scan_bwd.by_form_grouped[scan_dtype] += 1
    return ddt, ddx, dA, dB, dC, dh0


reset_counts()


def backward_chunks(dt, dx, A, Bc, Cc, dy, h0=None, dh_last=None,
                    seg_chunks: int = SEG_CHUNKS,
                    scan_dtype: str = "float32"):
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
    order. d(dx) and d(dt), sums over the states, are summed within each
    group of 64 states and then over the groups in order, as the kernels'
    groups are added. Returns (d(dt), d(dx), dA, dB, dC, dh0), dh0 None
    without h0.

    At a 16-bit ``scan_dtype`` (R: rounding to it) the chunk starts are
    the tree forward's states (``ref.selective_scan_tree``), the states
    between them h_t = a_t h_{t-1} + b_t in f32 at the rounded
    transitions a_t = R(exp(dt_t A)), b_t = R(dx_t B_t), and the adjoint
    takes R(C_t) and dC_t = sum_d dy_t R(h_t); every rounding passes its
    cotangent through, so d(dt) and dA take the unrounded exp(dt_t A)."""
    B, T, di = dt.shape
    ds = A.shape[1]
    f32 = torch.float32
    tree = form(scan_dtype) != 0
    sd = ref.scan_type(scan_dtype)
    dt, dx, Bc, Cc, dy = (t.to(f32) for t in (dt, dx, Bc, Cc, dy))
    A = A.to(f32)
    a2 = A * torch.tensor(LOG2E, dtype=f32)

    def rnd(v):
        return v.to(sd).to(f32) if tree else v

    def decay(t):
        """(the decay a_t, the exp its derivative takes)"""
        if not tree:
            a = torch.exp2(dt[:, t, :, None] * a2)
            return a, a
        e = torch.exp(dt[:, t, :, None] * A)
        return rnd(e), e

    def step(t, h):
        return decay(t)[0] * h + rnd(dx[:, t, :, None] * Bc[:, t, None, :])

    slices = _group_slices(ds)

    def by_groups(v):
        """v's sum over the states: each group's, then the groups' in
        order."""
        out = v[..., slices[0]].sum(-1)
        for sl in slices[1:]:
            out = out + v[..., sl].sum(-1)
        return out

    h = (torch.zeros((B, di, ds), dtype=f32, device=dt.device)
         if h0 is None else h0.to(f32))
    if tree:
        starts = ref.selective_scan_tree(dt, dx, A, Bc, Cc, h0, scan_dtype,
                                         every=BT)[2]
    else:
        starts = []
        for t in range(T):
            if t % BT == 0:
                starts.append(h)
            h = step(t, h)
    nseg = n_segments(T, seg_chunks)
    span = [(s * seg_chunks, min(len(starts), (s + 1) * seg_chunks))
            for s in range(nseg)]                         # chunks [c0, c1)
    lc, pc = {}, {}
    Cr = rnd(Cc)
    for s in range(1, nseg):                              # pass 1
        carry, prod = torch.zeros_like(h), torch.ones_like(h)
        for t in reversed(range(span[s][0] * BT, min(T, span[s][1] * BT))):
            at = decay(t)[0]
            carry = at * (dy[:, t, :, None] * Cr[:, t, None, :] + carry)
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
                h = step(t, h)
                dC[:, t] = (dy[:, t, :, None] * rnd(h)).sum(1)
            for t in reversed(range(t0, t1)):
                at, e = decay(t)
                g = dy[:, t, :, None] * Cr[:, t, None, :] + carry
                ddx[:, t] = by_groups(g * Bc[:, t, None, :])
                w = g * e * prev[t - t0]
                ddt[:, t] = by_groups(w * A)
                dA_parts[:, s] += w * dt[:, t, :, None]
                dB[:, t] = (g * dx[:, t, :, None]).sum(1)
                carry = at * g
        if s == 0:
            dh0 = carry
    dA = dA_parts[0, 0].clone()
    for p in dA_parts.reshape(B * nseg, di, ds)[1:]:      # in index order
        dA = dA + p
    return ddt, ddx, dA, dB, dC, None if h0 is None else dh0
