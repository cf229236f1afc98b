"""Flops and bytes of a call, counted op by op as it runs (the counterpart
of ``repro/analysis/hlo_cost.py``, which walks compiled HLO text).

PyTorch runs eagerly, so there is no program to walk: ``OpCounter`` is a
``TorchDispatchMode`` that sees every aten op a call dispatches and
counts

  * flops: contractions only (mm, addmm, bmm, baddbmm, mv, dot, ...),
    2 · output elements · contracted extent, as ``hlo_cost`` counts dots
    only;
  * bytes: the tensor operands plus the outputs of each op, views and
    allocations excepted, but for the ops that touch only a window of a
    larger operand, which count the window (the reference's rule,
    ``hlo_cost._io_bytes``): an in-place scatter or index write
    (``scatter_``, ``scatter_add_``, ``scatter_reduce_``, ``index_add_``,
    ``index_put_``, ``index_copy_``) 3 x its update operand (the window
    read, added to and written), a gather (``gather``, ``index_select``,
    ``index``) 2 x its output plus its indices. The reference reads a
    dynamic-update-slice's update window so; on an XLA ``scatter`` its
    code reads operand 1, which there is the index array, so the port
    keeps the rule its comment states, not that reading. A collective's
    c10d op counts its input and its output once each;
  * collective bytes: what ``launch/mesh.py``'s collectives moved while
    the counter was on (``Mesh.by_op``), an all-reduce counted twice (its
    reduce-scatter and all-gather phases), as ``roofline.py`` counts it.
    DTensor's functional collectives (``_c10d_functional``, the LM side's
    redistributions) are counted into the same ``Mesh.by_op`` by the
    counter itself, under ``optable.FUNCTIONAL_COLLECTIVES``' names, at
    their input's bytes.

A DTensor op is not counted as such: the counter defers it to DTensor,
whose local ops (each rank's share) and collectives it then sees. The
fake tensors DTensor's sharding propagation runs global shapes through
(on a cache miss only) are not counted either.

The hand-written kernels are reached through ctypes, so a dispatch mode
sees nothing of them on the card, while on the CPU the same call runs the
plain version step by step. So every dispatch function of
``kernels/ops.py`` is a ``kernel_region``: inside one, aten counting is
suspended and the kernel registry's ``work`` for the call's shapes is
counted instead. One call then counts the same on the card and on the
CPU. With no counter on, a region costs one global read. A region whose
count depends on the ids a call selects (the rows a rescore touches) and
whose ids were not there to read (meta tensors) counts the most rows the
call can touch; ``OpCounter.id_bound`` lists those regions apart, so a
comparison can leave them out.

``OpCounter(live=True)`` also tracks live bytes (``LiveBytes``): every
storage that first appears as an op's output (or a region's) adds its
bytes while it lives, and ``peak_bytes`` keeps the most at once. Storages
made before the counter, and a region's scratch, are not counted. It
needs no data, so a call lowered on meta tensors gives its peak too.
"""
from __future__ import annotations

import functools
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import optable

# the observer of kernel regions while one is on: an OpCounter or the
# check's dispatch pass (one at a time; entering one keeps the previous
# and leaving it puts that back)
_ACTIVE = None

# ops that move no bytes of their own: allocations and aliases
_NO_BYTES = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "_unsafe_view", "lift_fresh", "lift_fresh_copy",
    "_local_scalar_dense", "resize_", "set_", "record_stream"})


def kernel_region(name: str, cfg, kernel: Optional[str] = None):
    """Decorator of a dispatch function of ``kernels/ops.py``: the call is
    one launch of the registered kernel ``kernel`` (default ``name``),
    whose config ``cfg(result, *args, **kwargs)`` gives from the call's
    operands and result. Only an active observer reads it."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            obs = _ACTIVE
            if obs is None:
                return fn(*args, **kw)
            return obs.kernel(name, kernel or name, cfg, fn, args, kw)
        return run
    return wrap


def tensors(obj):
    """The tensors in ``obj``: a tensor, or any nesting of tuples, lists,
    dicts and dataclasses of them."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from tensors(o)
    elif hasattr(obj, "__dataclass_fields__"):
        for k in obj.__dataclass_fields__:
            yield from tensors(getattr(obj, k))


def _has_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def _is_fake(types, out) -> bool:
    """Whether an op ran on fake tensors (DTensor's shape propagation)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return any(issubclass(t, FakeTensor) for t in types) or any(
        isinstance(t, FakeTensor) for t in tensors(out))


class Observer(TorchDispatchMode):
    """A dispatch mode that also observes kernel regions: ``aten`` sees
    each op outside a region, ``region`` each region once it returned
    (with the kernel's config where ``wants_cfg``)."""

    wants_cfg = True
    regions = True

    def __init__(self):
        super().__init__()
        self._inside = 0
        self._prev = None

    def __enter__(self):
        global _ACTIVE
        self._prev, _ACTIVE = _ACTIVE, self
        return super().__enter__()

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._prev
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _has_dtensor(types):
            return NotImplemented      # DTensor runs it on local tensors
        out = func(*args, **kwargs)
        if not self._inside and not _is_fake(types, out):
            self.aten(func, args, kwargs, out)
        return out

    def kernel(self, name, kernel, cfg, fn, args, kw):
        if self._inside or not self.regions:   # a region inside a region:
            return fn(*args, **kw)             # the outer one counts
        self._inside += 1
        try:
            out = fn(*args, **kw)
            c = cfg(out, *args, **kw) if self.wants_cfg else None
        finally:
            self._inside -= 1
        self.region(name, kernel, c, args, kw, out)
        return out

    def aten(self, func, args, kwargs, out) -> None:
        pass

    def region(self, name, kernel, cfg, args, kw, out) -> None:
        pass


def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(obj))


# in-place writes into a window of their first operand: op -> position of
# the update operand (a number there writes index-many elements)
_WINDOW_WRITES = {"scatter_": 3, "scatter_add_": 3, "scatter_reduce_": 3,
                  "index_add_": 3, "index_copy_": 3, "index_put_": 2}
# reads of a window of their first operand: op -> position of the indices
_WINDOW_READS = {"gather": 2, "index_select": 2, "index": 1}


def io_bytes(name: str, args, kwargs, out) -> int:
    """The bytes one aten op moves: its tensor operands and outputs, or
    for a window op the window alone (module docstring). A collective
    (the c10d ops ``launch/mesh.py`` runs) counts its input and its
    output once each, as the reference counts an HLO collective's
    operand and output: c10d passes the output in as an argument too."""
    if name == "allgather_":        # (outputs, inputs, group, ...)
        return _nbytes(args[0]) + _nbytes(args[1])
    if name == "allreduce_":        # (tensors, group, ...): in place
        return 2 * _nbytes(args[0])
    if name in _WINDOW_WRITES:
        upd = args[_WINDOW_WRITES[name]]
        if isinstance(upd, torch.Tensor):
            return 3 * _nbytes(upd)
        # scatter_(self, dim, index, value): index-many elements written
        return 3 * args[2].numel() * args[0].element_size()
    if name in _WINDOW_READS:
        return 2 * _nbytes(out) + _nbytes(args[_WINDOW_READS[name]])
    return _nbytes(args) + _nbytes(kwargs) + _nbytes(out)


class LiveBytes:
    """Live and peak bytes of the storages a call makes, as they appear
    and die (``weakref.finalize`` on each untyped storage; the storage's
    Python object is kept for as long as the storage lives). ``see``
    takes one op's operands and outputs: a storage first met as an
    operand was there before and is never counted."""

    def __init__(self):
        self.now = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}     # id(storage) -> bytes counted
        self._finalizers = []

    def _meet(self, t, count: bool) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        n = st.nbytes() if count else 0
        self._sizes[key] = n
        self._finalizers.append(weakref.finalize(st, self._die, key))
        self.now += n
        self.peak = max(self.peak, self.now)

    def _die(self, key: int) -> None:
        self.now -= self._sizes.pop(key)

    def see(self, operands, outputs) -> None:
        for t in tensors(operands):
            self._meet(t, False)
        for t in tensors(outputs):
            self._meet(t, True)

    def close(self) -> None:
        """Stop following the storages still alive."""
        for f in self._finalizers:
            f.detach()
        self._finalizers.clear()


def contraction_flops(name: str, args, out) -> float:
    """2 · output elements · contracted extent of one contraction op (for
    addbmm, times the batch it sums over)."""
    lhs = args[1] if name in ("addmm", "baddbmm", "addbmm", "addmv") \
        else args[0]
    k = lhs.shape[-1]
    n_out = out.numel()
    if name == "addbmm":
        n_out *= lhs.shape[0]
    return 2.0 * n_out * k


class OpCounter(Observer):
    """Counts a call's flops, bytes and collective bytes (module
    docstring). ``mesh``, where given, is the ``launch.mesh.Mesh`` whose
    collectives are counted. ``regions=False`` walks into kernel regions
    and counts the plain version's ops instead of the registry's work:
    on the CPU only, where the plain version runs (the card's kernels
    are invisible to it). ``live=True`` tracks live bytes (``LiveBytes``;
    ``peak_bytes``). ``id_bound`` holds the regions counted from a bound
    on their ids (meta ids, module docstring).

        with OpCounter() as c:
            trainer.iteration(...)
        c.flops, c.bytes, c.coll_bytes, c.kernels
    """

    def __init__(self, mesh=None, regions: bool = True, live: bool = False):
        super().__init__()
        self.mesh = mesh
        self.regions = regions
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op: Dict[str, list] = {}       # op -> [calls, flops, bytes]
        self.kernels: Dict[str, list] = {}     # region -> [calls, flops, bytes]
        # the regions of ``kernels`` counted from a bound on their ids
        self.id_bound: Dict[str, list] = {}
        self.coll: Dict[str, float] = {}
        self._coll0: Dict[str, int] = {}
        self.live = LiveBytes() if live else None

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())

    @property
    def peak_bytes(self) -> Optional[float]:
        """The most bytes the call's own storages held at once (``live``)."""
        return None if self.live is None else float(self.live.peak)

    def __enter__(self):
        if self.mesh is not None:
            self._coll0 = {k: v[1] for k, v in self.mesh.by_op.items()}
        return super().__enter__()

    def __exit__(self, *exc):
        if self.mesh is not None:
            for k, v in self.mesh.by_op.items():
                moved = v[1] - self._coll0.get(k, 0)
                if moved:
                    self.coll[k] = (self.coll.get(k, 0.0)
                                    + optable.LINK_CROSSINGS[k] * moved)
        if self.live is not None:
            self.live.close()
        return super().__exit__(*exc)

    @staticmethod
    def _tally(table, key, flops, nbytes):
        rec = table.setdefault(key, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes

    def _add(self, table, key, flops, nbytes):
        self._tally(table, key, flops, nbytes)
        self.flops += flops
        self.bytes += nbytes

    def aten(self, func, args, kwargs, out) -> None:
        if self.live is not None:
            self.live.see((args, kwargs), out)
        name = optable.op_name(func)
        if func.is_view or name in _NO_BYTES:
            return
        coll = optable.FUNCTIONAL_COLLECTIVES.get(name)
        if coll is not None and func.namespace == "_c10d_functional" \
                and self.mesh is not None:
            by = self.mesh.by_op.setdefault(coll, [0, 0])
            by[0] += 1
            by[1] += _nbytes(args[0])
        flops = (contraction_flops(name, args, out)
                 if name in optable.CONTRACTION_OPS else 0.0)
        self._add(self.by_op, name, flops, io_bytes(name, args, kwargs, out))

    def region(self, name, kernel, cfg, args, kw, out) -> None:
        from repro_torch.kernels import registry
        if self.live is not None:
            self.live.see((args, kw), out)
        flops, nbytes, _ = registry.get(kernel).cost(cfg)
        self._add(self.kernels, name, flops, nbytes)
        if cfg.get("rows_bound"):
            self._tally(self.id_bound, name, flops, nbytes)
