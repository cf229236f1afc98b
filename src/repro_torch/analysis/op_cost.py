"""Flops and bytes of a call, counted op by op as it runs (the counterpart
of ``repro/analysis/hlo_cost.py``, which walks compiled HLO text).

PyTorch runs eagerly, so there is no program to walk: ``OpCounter`` is a
``TorchDispatchMode`` that sees every aten op a call dispatches and
counts

  * flops: contractions only (mm, addmm, bmm, baddbmm, mv, dot, ...),
    2 · output elements · contracted extent, as ``hlo_cost`` counts dots
    only;
  * bytes: the tensor operands plus the outputs of each op, views and
    allocations excepted;
  * collective bytes: what ``launch/mesh.py``'s collectives moved while
    the counter was on (``Mesh.by_op``), an all-reduce counted twice (its
    reduce-scatter and all-gather phases), as ``roofline.py`` counts it.

The hand-written kernels are reached through ctypes, so a dispatch mode
sees nothing of them on the card, while on the CPU the same call runs the
plain version step by step. So every dispatch function of
``kernels/ops.py`` is a ``kernel_region``: inside one, aten counting is
suspended and the kernel registry's ``work`` for the call's shapes is
counted instead. One call then counts the same on the card and on the
CPU. With no counter on, a region costs one global read.
"""
from __future__ import annotations

import functools
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
        out = func(*args, **kwargs)
        if not self._inside:
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
    are invisible to it).

        with OpCounter() as c:
            trainer.iteration(...)
        c.flops, c.bytes, c.coll_bytes, c.kernels
    """

    def __init__(self, mesh=None, regions: bool = True):
        super().__init__()
        self.mesh = mesh
        self.regions = regions
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op: Dict[str, list] = {}       # op -> [calls, flops, bytes]
        self.kernels: Dict[str, list] = {}     # region -> [calls, flops, bytes]
        self.coll: Dict[str, float] = {}
        self._coll0: Dict[str, int] = {}

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())

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
        return super().__exit__(*exc)

    def _add(self, table, key, flops, nbytes):
        rec = table.setdefault(key, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def aten(self, func, args, kwargs, out) -> None:
        name = optable.op_name(func)
        if func.is_view or name in _NO_BYTES:
            return
        flops = (contraction_flops(name, args, out)
                 if name in optable.CONTRACTION_OPS else 0.0)
        self._add(self.by_op, name, flops,
                  _nbytes(args) + _nbytes(kwargs) + _nbytes(out))

    def region(self, name, kernel, cfg, args, kw, out) -> None:
        from repro_torch.kernels import registry
        flops, nbytes, _ = registry.get(kernel).cost(cfg)
        self._add(self.kernels, name, flops, nbytes)
