"""Meshes of ranks on ``torch.distributed`` (the port of
``repro/launch/mesh.py``): the one place ranks, devices and process groups
are put together.

A JAX mesh is an array of devices driven by one program. Here each rank
is a process of its own that holds one device, and a ``Mesh`` is what a
rank knows of the whole: the axis names (``('data', 'model')`` or
``('pod', 'data', 'model')``), their extents, its own coordinates, one
process group per axis plus one over the data axes together, and its
device. Ranks are laid out row-major over the axes, as the JAX package
reshapes its device list, so the model axis varies fastest.

``resolve_mesh`` is the trainer-facing entry point: a ``Mesh``, a
``(data, model)`` tuple, a config's ``mesh`` or None all come out as a
concrete ``Mesh``, with the reference's divisibility errors. With no
process group initialised the default mesh is one rank: the engine then
takes its local path, bit for bit.

The backend is the caller's choice and is never swapped behind its back:
``nccl`` where each rank has its own card, ``gloo`` on the CPU and, when
the caller asks for it, on a shared card (``gloo`` stages CUDA tensors
through the host; NCCL refuses two ranks on one device). ``run_ranks``
spawns the ranks of one world with a file-store rendezvous and a time
limit of its own; tests and ``chip_smoke.py`` share it.

``fake_world`` and ``make_production_mesh`` lower a step without a
cluster (``launch/dryrun.py``): one process takes one rank of a world of
256 or 512 on torch's ``fake`` backend, whose collectives move nothing,
and runs its share of the step on meta tensors.

Every collective of the mesh path goes through the helpers below, which
count the bytes each rank contributes (``Mesh.comm``) and, with
``Mesh.timing`` on, the seconds from a device synchronise before the
collective to one after it. ``all_to_all`` and ``ppermute_ring`` are the
reference's ``lax.all_to_all`` and ``lax.ppermute`` over one axis, with
their transposes as backward (the LM side's MoE dispatch and ring
attention). The LM side's other collectives are DTensor's
(``sharding/``), which ``analysis/op_cost.OpCounter`` counts into the
same ``Mesh.by_op``.
"""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


@dataclass(eq=False)
class Mesh:
    """One rank's view of an SPMD mesh of ranks.

    ``groups[axis]`` is the process group of the ranks that share every
    other coordinate (None where the axis has extent 1), ``data_group``
    the group of the ranks that share the model coordinate (None where
    the data axes have extent 1). ``comm`` counts what the collectives
    moved, by kind: {kind: [calls, bytes, seconds]}; ``by_op`` the same
    bytes by collective ('all-gather', 'all-reduce'): {op: [calls,
    bytes]}, which ``analysis/op_cost.py`` reads.
    """
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    device: torch.device
    backend: Optional[str] = None
    groups: Dict[str, Optional[object]] = field(default_factory=dict)
    data_group: Optional[object] = None
    timing: bool = False
    comm: Dict[str, list] = field(default_factory=dict)
    by_op: Dict[str, list] = field(default_factory=dict)

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def rank(self) -> int:
        return int(np.ravel_multi_index(self.coords, self.shape))

    @property
    def model_extent(self) -> int:
        return self.sizes.get("model", 1)

    @property
    def data_extent(self) -> int:
        return self.size // self.model_extent

    @property
    def model_rank(self) -> int:
        return dict(zip(self.axis_names, self.coords)).get("model", 0)

    @property
    def data_rank(self) -> int:
        """Row-major index of this rank over the data axes."""
        data = [(c, s) for a, c, s in zip(self.axis_names, self.coords,
                                          self.shape) if a != "model"]
        if not data:
            return 0
        return int(np.ravel_multi_index([c for c, _ in data],
                                        [s for _, s in data]))


def default_device(rank: int = 0) -> torch.device:
    """A rank's card: ``cuda:<rank mod cards>`` (``resolve_device`` raises
    without one: no rank carries on on the CPU)."""
    resolve_device("cuda")
    return torch.device("cuda", rank % torch.cuda.device_count())


def check_backend(backend: str, devices: Sequence) -> None:
    """Refuse a backend that cannot serve these per-rank devices: NCCL
    needs a card of its own for every rank."""
    devices = [torch.device(d) for d in devices]
    if backend == "nccl":
        if any(d.type != "cuda" for d in devices):
            raise ValueError(f"backend='nccl' needs CUDA devices, got "
                             f"{[str(d) for d in devices]}; use "
                             "backend='gloo' on the CPU")
        seen = {}
        for r, d in enumerate(devices):
            if d in seen:
                raise ValueError(
                    f"backend='nccl': ranks {seen[d]} and {r} share {d}, "
                    "and NCCL refuses two ranks on one device; pass "
                    "backend='gloo' to run several ranks on one card")
            seen[d] = r
    elif backend != "gloo":
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")


def _new_groups(shape, axis_names, backend):
    """Every rank creates every group, in one order (``new_group`` is
    collective); returns this rank's group per axis and over the data
    axes together."""
    me = dist.get_rank()
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    groups = {}
    for i, a in enumerate(axis_names):
        if shape[i] == 1:
            groups[a] = None
            continue
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
        for ranks in lines:
            g = dist.new_group([int(r) for r in ranks], backend=backend)
            if me in ranks:
                groups[a] = g
    data_group = None
    mi = axis_names.index("model")
    if grid.size // shape[mi] > 1:
        lines = np.moveaxis(grid, mi, 0).reshape(shape[mi], -1)
        for ranks in lines:
            g = dist.new_group([int(r) for r in ranks], backend=backend)
            if me in ranks:
                data_group = g
    return groups, data_group


# process groups are process-wide, so the meshes built on them are kept
# per world: SPMD ranks ask for the same meshes in the same order
_MESHES: Dict[tuple, Mesh] = {}


def make_local_mesh(data: int = 1, model: int = 1, pod: int = 0, *,
                    backend: Optional[str] = None, device=None) -> Mesh:
    """A ('data', 'model') mesh (('pod', 'data', 'model') with ``pod``)
    over the ranks of the initialised world, whose size it must equal. A
    one-rank mesh needs no process group. ``device`` defaults to
    ``default_device(rank)``; ``backend`` to the world's. In a
    ``fake_world`` the device is ``meta`` and the groups are fake ones:
    there are no other ranks to ask for their devices."""
    shape = (pod, data, model) if pod else (data, model)
    axes = POD_AXES if pod else AXES
    n = int(np.prod(shape))
    if min(shape) < 1:
        raise ValueError(f"mesh extents must be positive, got {shape}")
    initialised = dist.is_available() and dist.is_initialized()
    if n == 1:
        rank = dist.get_rank() if initialised else 0
        dev = (default_device(rank) if device is None
               else resolve_device(device))
        return Mesh(axes, shape, (0,) * len(shape), dev)
    if not initialised:
        raise RuntimeError(
            f"a {shape} mesh needs {n} ranks: initialise torch.distributed "
            "first (launch.mesh.run_ranks spawns them)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {shape} mesh of {n} ranks in a world of "
                         f"{world}: a mesh spans the whole world")
    rank = dist.get_rank()
    fake = dist.get_backend() == "fake"
    if fake:
        dev, backend = torch.device("meta"), "fake"
        if device is not None and torch.device(device) != dev:
            raise ValueError(f"a fake world's mesh is on meta, not {device}")
    else:
        dev = (default_device(rank) if device is None
               else resolve_device(device))
        backend = backend or dist.get_backend()
    key = (id(dist.group.WORLD), shape, backend, str(dev))
    if key in _MESHES:
        return _MESHES[key]
    if not fake:
        devices = [None] * world
        probe = dist.new_group(backend="gloo")
        dist.all_gather_object(devices, str(dev), group=probe)
        dist.destroy_process_group(probe)
        check_backend(backend, devices)
    if backend == "gloo" and dev.type == "cuda":
        _gloo_cuda_all_gather()
    groups, data_group = _new_groups(shape, axes, backend)
    mesh = Mesh(axes, shape, tuple(int(c) for c in np.unravel_index(
        rank, shape)), dev, backend, groups, data_group)
    _MESHES[key] = mesh
    return mesh


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """A world of ``world`` ranks on torch's ``fake`` backend, this
    process its rank ``rank``: collectives complete at once and move
    nothing, so one process runs one rank's share of a step on meta
    tensors. Refuses inside an initialised world; on exit destroys the
    world and drops the meshes made on it."""
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialised in this process")
    # registers the 'fake' backend (torch's own, kept under testing)
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank,
                            world_size=world)
    before = set(_MESHES)
    try:
        yield
    finally:
        for k in set(_MESHES) - before:
            del _MESHES[k]
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 ranks ('data', 'model'), or 2 x 16 x 16 = 512
    ('pod', 'data', 'model') with ``multi_pod``, as the reference builds
    them: this rank's mesh in the ``fake_world`` of that size (device
    ``meta``, fake process groups)."""
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_backend() == "fake"):
        raise RuntimeError("make_production_mesh: lower inside "
                           "fake_world(512 if multi_pod else 256)")
    return make_local_mesh(16, 16, 2 if multi_pod else 0)


def _largest_divisor_leq(n: int, cap: int) -> int:
    for d in range(min(n, cap), 0, -1):
        if n % d == 0:
            return d
    return 1


def make_default_mesh(n_utts: Optional[int] = None,
                      n_components: Optional[int] = None, *,
                      device=None) -> Mesh:
    """The default trainer substrate: data-parallel over the whole world,
    model axis 1; one rank when no process group is initialised (the
    local path, bit for bit). A JAX mesh may take a subset of the devices
    that the utterances divide into; a world of ranks cannot leave ranks
    out, so ``resolve_mesh`` reports a count that does not divide."""
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    return make_local_mesh(data=world, model=1, device=device)


def resolve_mesh(mesh, n_utts: Optional[int] = None,
                 n_components: Optional[int] = None, *, device=None) -> Mesh:
    """Normalise a mesh description to a concrete Mesh: a ``Mesh``
    (returned as is), a ``(data, model)`` tuple, or None (auto:
    ``make_default_mesh``). Validates the utterance and component counts
    against the axes, so a bad split fails here with the reference's
    message instead of inside the engine. ``device`` places a mesh built
    here."""
    if mesh is None:
        mesh = make_default_mesh(n_utts, n_components, device=device)
    elif isinstance(mesh, (tuple, list)):
        if len(mesh) != 2:
            raise ValueError(f"mesh tuple must be (data, model), got {mesh}")
        mesh = make_local_mesh(data=int(mesh[0]), model=int(mesh[1]),
                               device=device)
    elif not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a Mesh, (data, model) tuple or "
                        f"None, got {type(mesh)}")
    d, m = mesh.data_extent, mesh.model_extent
    if n_utts is not None and n_utts % d:
        raise ValueError(f"{n_utts} utterances do not divide the mesh's "
                         f"data extent {d} ({mesh.sizes})")
    if n_components is not None and n_components % m:
        raise ValueError(f"{n_components} components do not divide the "
                         f"mesh's model extent {m}")
    return mesh


def mesh_descriptor(mesh) -> Optional[Tuple[Tuple[str, int], ...]]:
    """Hashable/JSON-able ((axis, size), ...) descriptor: what provenance
    records instead of the ranks."""
    if mesh is None:
        return None
    return tuple((str(a), int(s)) for a, s in zip(mesh.axis_names,
                                                   mesh.shape))


# ---------------------------------------------------------------------------
# Blocks of a global array
# ---------------------------------------------------------------------------


def _block(t, parts: int, i: int, what: str):
    n = t.shape[0]
    if n % parts:
        raise ValueError(f"{n} {what} do not divide into {parts} blocks")
    step = n // parts
    return t[i * step:(i + 1) * step]


def data_block(mesh: Mesh, t, device=True):
    """This rank's block of the rows of ``t`` over the data axes (rank
    order), on the rank's device unless ``device`` is False."""
    if t is None:
        return None
    b = _block(t, mesh.data_extent, mesh.data_rank, "rows")
    return b.to(mesh.device) if device else b


def model_rows(mesh: Mesh, t):
    """This rank's block of the component rows of ``t`` (dim 0 = C)."""
    if t is None:
        return None
    return _block(t, mesh.model_extent, mesh.model_rank, "components")


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _run(mesh: Mesh, kind: str, collective: str, nbytes: int, op):
    rec = mesh.comm.setdefault(kind, [0, 0, 0.0])
    rec[0] += 1
    rec[1] += nbytes
    by = mesh.by_op.setdefault(collective, [0, 0])
    by[0] += 1
    by[1] += nbytes
    if not mesh.timing:
        return op()
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    out = op()
    if cuda:
        torch.cuda.synchronize(mesh.device)
    rec[2] += time.perf_counter() - t0
    return out


def all_reduce(mesh: Mesh, t, group, kind: str, op="sum"):
    """Sum (or max) of ``t`` over ``group``, in place; returns ``t``."""
    if group is None:
        return t
    t = t.contiguous()
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    _run(mesh, kind, "all-reduce", t.numel() * t.element_size(),
         lambda: dist.all_reduce(t, op=rop, group=group))
    return t


def all_gather(mesh: Mesh, t, group, kind: str):
    """[every rank's ``t``] over ``group``, in group-rank order."""
    if group is None:
        return [t]
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    _run(mesh, kind, "all-gather", t.numel() * t.element_size(),
         lambda: dist.all_gather(out, t, group=group))
    return out


def _a2a(mesh: Mesh, t, group, kind: str, collective: str, out_splits=None,
         in_splits=None):
    t = t.contiguous()
    rows = t.shape[0] if out_splits is None else sum(out_splits)
    out = t.new_empty((rows,) + tuple(t.shape[1:]))
    _run(mesh, kind, collective, t.numel() * t.element_size(),
         lambda: dist.all_to_all_single(out, t, out_splits, in_splits,
                                        group=group))
    return out


class _AllToAll(torch.autograd.Function):
    """out[j] = (rank j's t)[me] over ``group``, t [P, ...]; its
    transpose is the same exchange."""

    @staticmethod
    def forward(ctx, t, mesh, group, kind):
        ctx.args = (mesh, group, kind)
        return _a2a(mesh, t, group, kind, "all-to-all")

    @staticmethod
    def backward(ctx, g):
        return (_a2a(ctx.args[0], g, ctx.args[1], ctx.args[2],
                     "all-to-all"), None, None, None)


def all_to_all(mesh: Mesh, t, group, kind: str):
    """The reference's ``lax.all_to_all(t, axis, 0, 0, tiled=False)``
    over ``group`` (P ranks): t [P, ...]; block j goes to group rank j,
    and block i of the result came from group rank i. Differentiable (the
    backward is the same exchange of the gradient), counted as
    'all-to-all'."""
    if group is None:
        return t
    return _AllToAll.apply(t, mesh, group, kind)


def _shift(mesh: Mesh, t, group, kind: str, step: int):
    """Send ``t`` to group rank (me + step) mod P, receive from (me -
    step): one ``all_to_all_single`` whose splits hold one non-empty
    block each way (gloo's send and recv take CPU tensors only; this
    runs on gloo with CUDA tensors and on NCCL alike)."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    rows = t.shape[0]
    ins = [0] * n
    outs = [0] * n
    ins[(me + step) % n] = rows
    outs[(me - step) % n] = rows
    return _a2a(mesh, t, group, kind, "collective-permute", outs, ins)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, group, kind):
        ctx.args = (mesh, group, kind)
        return _shift(mesh, t, group, kind, 1)

    @staticmethod
    def backward(ctx, g):
        return (_shift(ctx.args[0], g, ctx.args[1], ctx.args[2], -1),
                None, None, None)


def ppermute_ring(mesh: Mesh, t, group, kind: str):
    """The reference's ``lax.ppermute`` with perm [(i, i + 1 mod P)]: each
    group rank's ``t`` goes to the next, wrapping. Differentiable (the
    backward is the reverse shift), counted as 'collective-permute'."""
    if group is None:
        return t
    return _Permute.apply(t, mesh, group, kind)


_GLOO_CUDA = []


def _gloo_cuda_all_gather() -> None:
    """Run DTensor's functional all-gather of CUDA tensors through the
    c10d ``all_gather_into_tensor``: on a gloo group the functional op
    crashes the process with CUDA tensors (torch 2.11 on the H100), while
    the c10d call, like the functional reduce-scatter, all-reduce and
    all-to-all, runs. Installed once in a process whose mesh is gloo on
    a card; NCCL groups take the same c10d path."""
    if _GLOO_CUDA:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")

    def all_gather_into_tensor(t, group_size, group_name):
        from torch.distributed.distributed_c10d import \
            _resolve_process_group
        out = t.new_empty((t.shape[0] * group_size,) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous(),
                                    group=_resolve_process_group(group_name))
        return out

    lib.impl("all_gather_into_tensor", all_gather_into_tensor, "CUDA")
    _GLOO_CUDA.append(lib)


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh's world."""
    if mesh.size > 1:
        dist.barrier()


# ---------------------------------------------------------------------------
# Spawning the ranks of one world
# ---------------------------------------------------------------------------


def _rank_entry(fn, args, rank, world, backend, store, timeout, threads,
                results):
    try:
        torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            # pickled by value here: the queue's own pickler would share
            # tensors through this process, which may exit before the
            # parent has read them
            results.put((rank, True, pickle.dumps(fn(*args))))
        finally:
            dist.destroy_process_group()
    except BaseException:   # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, *, args: tuple = (),
              backend: Optional[str] = None, device=None,
              timeout: float = 300.0, workdir=None,
              threads: Optional[int] = None) -> list:
    """Run ``fn(*args)`` on ``world`` spawned ranks of one process group
    and return their results in rank order.

    ``fn`` must be importable by the spawned interpreter (a module-level
    function). ``backend`` defaults to ``nccl`` for CUDA ``device`` and
    ``gloo`` for the CPU; ``device`` (default ``cuda``) is what each rank
    passes to ``make_local_mesh`` as ``default_device`` does: on CUDA,
    rank r takes ``cuda:<r mod cards>``. NCCL on a shared card raises
    here, before any rank starts. Rendezvous goes through a file store in
    ``workdir`` (a temporary directory when None); every collective
    times out after ``timeout`` seconds, and the parent stops waiting at
    ``timeout`` too, terminating the ranks and raising. A rank that
    raises makes this raise, with its traceback. Each rank runs torch's
    host ops on ``threads`` threads (default: this machine's cores shared
    out, ``max(1, cpu_count // world)``), so that a world does not ask
    for ``world`` times the cores there are. A CPU caller that holds the
    ranks bitwise to a one-rank run of its own must run that at the same
    ``threads`` (``torch.set_num_threads``): host reductions sum in an
    order that depends on the thread count.
    """
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        resolve_device(dev)
        n = torch.cuda.device_count()
        devices = [torch.device("cuda", r % n) if dev.index is None else dev
                   for r in range(world)]
    else:
        devices = [dev] * world
    check_backend(backend, devices)
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world)
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="ranks_") if own else str(workdir)
    store = os.path.join(workdir, f"store_{os.getpid()}_{time.time_ns()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, args=(
        fn, args, r, world, backend, store, timeout, threads, results),
        daemon=True)
        for r in range(world)]
    out, errors = {}, {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                if errors:
                    break
                raise TimeoutError(
                    f"run_ranks: {world - len(out)} of {world} ranks gave "
                    f"no result within {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and p.exitcode not in (0, None)
                        and r not in out and r not in errors]
                if dead and results.empty():
                    raise RuntimeError(
                        f"run_ranks: ranks {dead} exited with codes "
                        f"{[procs[r].exitcode for r in dead]} and no "
                        "result") from None
                continue
            if ok:
                out[rank] = pickle.loads(value)
            else:
                # the others may be blocked in a collective, or fail in
                # turn from the lost peer: gather what comes in shortly
                errors[rank] = value
                deadline = min(deadline, time.monotonic() + 5.0)
        if errors:
            raise RuntimeError("run_ranks: " + "\n".join(
                f"rank {r} failed:\n{tb}" for r, tb in sorted(errors.items())))
        return [out[r] for r in range(world)]
    finally:
        clean = len(out) == world
        for p in procs:
            p.join(timeout=5 if clean else 0.1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
