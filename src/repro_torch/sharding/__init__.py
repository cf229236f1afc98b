"""Logical-axis sharding on DTensor: named logical axes resolved to mesh
axes by rules (the port of ``repro/sharding/__init__.py``).

Model code tags tensors with *logical* axis names ('batch', 'heads',
'ffn', 'experts', 'vocab', ...). A ``Rules`` object (built per arch x
shape x mesh by ``make_rules``) maps logical names to the axes of a
``launch.mesh.Mesh``, with the reference's divisibility fallbacks: a
logical axis whose dimension does not divide over its mesh axes is
replicated, and recorded in ``Rules.fallbacks`` for the dry-run report.

Where the JAX package hands GSPMD a ``NamedSharding``, the port holds a
DTensor over the ``DeviceMesh`` that ``Rules.device_mesh`` builds from
the ``Mesh``'s own process groups (no new group is made, so no rank can
create groups in another order than the others). ``tag`` is the
reference's ``with_sharding_constraint``: a ``redistribute`` of a
DTensor to the placements its logical axes give. A mesh axis of extent 1
has no process group and no dimension of the DeviceMesh; placements are
given over the axes of extent > 1 only.

When no rules are active (one card, the CPU tests), tagging is a no-op
and no DTensor is made.
"""
from __future__ import annotations

import contextlib
import contextvars
import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

AxisVal = Union[None, str, Tuple[str, ...]]


def _sizes(mesh) -> Dict[str, int]:
    """{axis: extent} of a port ``Mesh`` (or of anything with a
    ``shape`` dict, as a JAX mesh has)."""
    sizes = getattr(mesh, "sizes", None)
    return dict(sizes if sizes is not None else mesh.shape)


@dataclass(eq=False)
class Rules:
    mesh: object
    table: Dict[str, AxisVal]
    fallbacks: list = field(default_factory=list)
    _device_mesh: object = field(default=None, repr=False)

    def axis_size(self, mesh_axes: AxisVal) -> int:
        if mesh_axes is None:
            return 1
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        sizes = _sizes(self.mesh)
        n = 1
        for a in mesh_axes:
            n *= sizes[a]
        return n

    def spec(self, dims: int, axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Tuple[AxisVal, ...]:
        """The per-dim mesh axes of logical ``axes`` (the reference's
        ``PartitionSpec`` entries: a one-axis tuple is its axis); drops
        non-divisible entries."""
        assert len(axes) == dims, (axes, dims)
        entries = []
        for i, name in enumerate(axes):
            mesh_axes = self.table.get(name) if name else None
            if mesh_axes is not None and shape is not None:
                if shape[i] % self.axis_size(mesh_axes) != 0:
                    self.fallbacks.append((name, tuple(shape), i))
                    mesh_axes = None
            if isinstance(mesh_axes, tuple) and len(mesh_axes) == 1:
                mesh_axes = mesh_axes[0]      # as PartitionSpec keeps it
            entries.append(mesh_axes)
        return tuple(entries)

    @property
    def dm_axes(self) -> Tuple[str, ...]:
        """The mesh axes that are dimensions of the DeviceMesh: those of
        extent > 1, in mesh order."""
        sizes = _sizes(self.mesh)
        return tuple(a for a in self.mesh.axis_names if sizes[a] > 1)

    def placements_of(self, spec: Sequence[AxisVal]) -> tuple:
        """DTensor placements (one per DeviceMesh dimension) of a spec. A
        dim over several mesh axes takes them in mesh order, which is how
        DTensor nests two ``Shard`` of one dim: row-major, as JAX's."""
        from torch.distributed.tensor import Replicate, Shard
        order = list(self.mesh.axis_names)
        owner = {}
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            names = (entry,) if isinstance(entry, str) else tuple(entry)
            if [order.index(a) for a in names] != sorted(
                    order.index(a) for a in names):
                raise ValueError(f"spec entry {entry} is not in mesh order "
                                 f"{tuple(order)}")
            for a in names:
                if a in owner:
                    raise ValueError(f"mesh axis {a!r} shards dims "
                                     f"{owner[a]} and {d} of {spec}")
                owner[a] = d
        return tuple(Shard(owner[a]) if a in owner else Replicate()
                     for a in self.dm_axes)

    def placements(self, shape: Sequence[int],
                   axes: Sequence[Optional[str]]) -> tuple:
        """DTensor placements of a tensor of ``shape`` with logical
        ``axes`` (``spec`` with the fallbacks, then ``placements_of``)."""
        return self.placements_of(self.spec(len(shape), axes, shape))

    @property
    def device_mesh(self):
        """The DeviceMesh over the Mesh's ranks, its dimensions the axes
        of extent > 1, built once from the Mesh's process groups."""
        if self._device_mesh is None:
            self._device_mesh = device_mesh_of(self.mesh)
        return self._device_mesh

    @property
    def distributed(self) -> bool:
        """Whether the mesh has more than one rank (DTensors are made)."""
        return bool(self.dm_axes)

    def distribute(self, t: torch.Tensor, axes: Sequence[Optional[str]]):
        """This rank's shard of the global tensor ``t`` (every rank passes
        the same values) as a DTensor with ``axes``' placements. No
        collective: each rank cuts its own block."""
        from torch.distributed.tensor import DTensor, distribute_tensor
        pl = self.placements(t.shape, axes)
        d = distribute_tensor(t, self.device_mesh, pl, src_data_rank=None)
        loc = d.to_local()
        if loc.numel() < t.numel() and \
                loc.untyped_storage().data_ptr() == \
                t.untyped_storage().data_ptr():
            # a view of t's storage would keep all of t alive
            d = DTensor.from_local(loc.clone(), self.device_mesh, pl,
                                   shape=t.shape, stride=t.stride(),
                                   run_check=False)
        return d


# Mesh -> its DeviceMesh (a mesh dropped with its world drops its entry)
_DEVICE_MESHES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def device_mesh_of(mesh):
    """The DeviceMesh of a port ``Mesh`` of more than one rank, from its
    ``groups`` (one per axis of extent > 1). No process group is created:
    ``DeviceMesh.from_group`` wraps the existing ones."""
    from torch.distributed.device_mesh import DeviceMesh
    if mesh in _DEVICE_MESHES:
        return _DEVICE_MESHES[mesh]
    sizes = _sizes(mesh)
    names = tuple(a for a in mesh.axis_names if sizes[a] > 1)
    if not names:
        raise ValueError("a mesh of one rank has no DeviceMesh")
    ranks = torch.arange(mesh.size).reshape(mesh.shape)
    keep = tuple(slice(None) if sizes[a] > 1 else 0 for a in mesh.axis_names)
    # the ranks that share this rank's coordinates on the extent-1 axes
    # are the whole world: an axis of extent 1 has one coordinate
    grid = ranks[keep]
    dev = mesh.device.type
    dtype = "cpu" if dev == "meta" else dev
    groups = [mesh.groups[a] for a in names]
    dm = DeviceMesh.from_group(groups if len(groups) > 1 else groups[0],
                               dtype, mesh=grid, mesh_dim_names=names)
    _DEVICE_MESHES[mesh] = dm
    return dm


_ACTIVE: contextvars.ContextVar[Optional[Rules]] = contextvars.ContextVar(
    "repro_torch_sharding_rules", default=None)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    tok = _ACTIVE.set(rules)
    try:
        yield rules
    finally:
        _ACTIVE.reset(tok)


def active_rules() -> Optional[Rules]:
    return _ACTIVE.get()


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def tag(x, *axes: Optional[str]):
    """Constrain ``x``'s sharding by logical axis names: a ``redistribute``
    of a DTensor to the placements ``axes`` give under the active rules.
    A no-op without rules, and for a plain tensor (one rank)."""
    rules = _ACTIVE.get()
    if rules is None or not is_dtensor(x):
        return x
    want = rules.placements(x.shape, axes)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def model_axis_size() -> int:
    rules = _ACTIVE.get()
    if rules is None:
        return 1
    return rules.axis_size(rules.table.get("_model_axis", "model"))


# ---------------------------------------------------------------------------
# Rule construction (per arch x shape x mesh)
# ---------------------------------------------------------------------------


def make_rules(mesh, cfg=None, shape=None) -> Rules:
    """Default logical->physical mapping, the reference's.

    batch        -> all data-parallel axes ('pod' composes with 'data')
    heads/ffn/
    experts/vocab-> 'model' (tensor/expert parallel)
    fsdp         -> weight-dim sharding over the data axes (ZeRO-3-style);
                    within-pod only, so cross-pod traffic is grad sums.
    kv_heads     -> 'model' when the arch's kv-head count divides it;
                    otherwise the model axis moves to the cache sequence dim.
    """
    sizes = _sizes(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    has_model = "model" in sizes
    model = "model" if has_model else None
    msize = sizes.get("model", 1)

    table: Dict[str, AxisVal] = {
        "batch": data_axes or None,
        "seq": None,
        # sequence-parallel residual stream (train/prefill only: decode has
        # seq=1)
        "seq_sp": (model if (shape is None or shape.kind != "decode")
                   else None),
        "heads": model,
        "ffn": model,
        "experts": model,
        "vocab": model,
        "dmodel": None,
        "fsdp": ("data",) if "data" in sizes else None,
        "layers": None,
        "head_dim": None,
        "kv_heads": model,
        "cache_seq": None,
        "cache_batch": data_axes or None,
        "frames": None,
        "components": model,
        "utts": data_axes or None,
        "ivec": None,
        "feat": None,
    }

    if cfg is not None and getattr(cfg, "family", None) != "ivector":
        kvh = getattr(cfg, "n_kv_heads", 0)
        if has_model and kvh and kvh % msize != 0:
            # MQA/GQA with too few kv heads: shard the cache over sequence
            table["kv_heads"] = None
            table["cache_seq"] = model
        if shape is not None and shape.kind == "decode":
            gb = shape.global_batch
            dsize = 1
            for a in data_axes:
                dsize *= sizes[a]
            if gb % (dsize or 1) != 0:
                # tiny-batch decode (long_500k): batch replicated; spread
                # the cache sequence over the data axes instead
                table["batch"] = None
                table["cache_batch"] = None
                cur = table["cache_seq"]
                cur_t = (cur,) if isinstance(cur, str) else (cur or ())
                table["cache_seq"] = tuple(data_axes) + tuple(cur_t)
    return Rules(mesh=mesh, table=table)
