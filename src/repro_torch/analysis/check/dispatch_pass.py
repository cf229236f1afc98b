"""Pass 1: numerics hazards in the aten ops an entry dispatches
(NUM001-NUM004); the counterpart of ``repro/analysis/check/jaxpr_pass.py``.

PyTorch runs eagerly, so there is no jaxpr to walk: the entry runs once
under a dispatch mode on the device the caller names, and every aten op it
dispatches is checked as it happens:

  * NUM001 a contraction (mm, bmm, addmm, ...) with a bf16/fp16/fp8
    operand whose result is not f32;
  * NUM002 the LU family: linalg_solve, linalg_inv, linalg_lu_factor,
    linalg_slogdet, linalg_det (any ``_ex`` variant too);
  * NUM003 a reduction over the frame axis of a value that carries the
    features but not the mask. Entry inputs are tagged ('feats' |
    'mask' | none), tags union through every op (an in-place op's tags
    reach the tensor it writes and the bases it views), and the frame
    axis is found by extent (entries use a prime frame count);
  * NUM004 any float64 output.

A ``kernel_region`` (``analysis/op_cost.py``) is one op here: its
outputs take the union of its inputs' tags and nothing inside it is
walked, so an entry checks the same on the card, where the kernel is
invisible to the dispatcher, as on the CPU, where its plain version runs.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

import torch

from repro_torch.analysis import optable
from repro_torch.analysis.check.findings import Finding, make_finding
from repro_torch.analysis.op_cost import Observer, tensors

_WIDE = (torch.float32, torch.float64)


def _dims(name: str, args, kwargs, ndim: int):
    """The axes a reduction op folds, or None where it is not one."""
    dim = args[1] if len(args) > 1 else kwargs.get("dim")
    if name in ("var", "std") and isinstance(dim, bool):
        dim = None                    # var(x, unbiased)
    if dim is None or (isinstance(dim, (list, tuple)) and not dim):
        return list(range(ndim))
    if isinstance(dim, int):
        return [dim % max(ndim, 1)]
    if isinstance(dim, (list, tuple)) and all(isinstance(d, int)
                                              for d in dim):
        return [d % max(ndim, 1) for d in dim]
    return None


class _Walker(Observer):
    wants_cfg = False

    def __init__(self, entry: str, frame_extents: Set[int],
                 has_mask: bool):
        super().__init__()
        self.entry = entry
        self.frame_extents = frame_extents
        self.has_mask = has_mask
        self.findings: List[Finding] = []
        # id -> (tensor, tags); the tensor is held so its id stays its own
        self._tags: Dict[int, tuple] = {}
        self._base: Dict[int, torch.Tensor] = {}   # view -> the viewed

    def tag_of(self, t) -> Set[str]:
        rec = self._tags.get(id(t))
        return rec[1] if rec is not None and rec[0] is t else set()

    def seed(self, t, tags: Set[str]) -> None:
        self._tags[id(t)] = (t, set(tags))

    def _taint(self, t, tags: Set[str]) -> None:
        """Add ``tags`` to ``t`` and every tensor it is a view of."""
        seen = 0
        while t is not None and seen < 64:
            self.seed(t, self.tag_of(t) | tags)
            t = self._base.get(id(t))
            seen += 1

    def _loc(self) -> str:
        return f"entry:{self.entry}"

    def aten(self, func, args, kwargs, out) -> None:
        name = optable.op_name(func)
        ins = list(tensors(args)) + list(tensors(kwargs))
        in_tags: Set[str] = set()
        for t in ins:
            in_tags |= self.tag_of(t)
        outs = list(tensors(out))

        if name in optable.CONTRACTION_OPS:
            low = sorted({optable.dtype_name(t.dtype) for t in ins
                          if t.dtype in optable.LOW_PRECISION_DTYPES})
            if low and outs and outs[0].dtype not in _WIDE:
                self.findings.append(make_finding(
                    "NUM001", self._loc(),
                    f"'{name}' with {'/'.join(low)} operands returns "
                    f"{optable.dtype_name(outs[0].dtype)}",
                    "widen the operands to float32 first, or use a kernel "
                    "that accumulates and returns f32"))
        if optable.base_name(name) in optable.LU_FAMILY_OPS:
            self.findings.append(make_finding(
                "NUM002", self._loc(),
                f"'{name}' (pivoted LU) reached from entry '{self.entry}'",
                "replace torch.linalg.solve/inv/slogdet with "
                "torch.linalg.cholesky + cholesky_solve / "
                "solve_triangular (SPD operands)"))
        if (name in optable.REDUCE_OPS and func._overloadname != "other"
                and self.has_mask and self.frame_extents and ins):
            self._check_reduce(name, args, kwargs, ins[0])

        if func.is_view and ins and outs:
            self._base[id(outs[0])] = ins[0]
        schema = func._schema.arguments
        if (schema and schema[0].alias_info is not None
                and schema[0].alias_info.is_write and ins):
            self._taint(args[0], in_tags)   # in place: the written tensor
        for o in outs:
            self.seed(o, self.tag_of(o) | in_tags)
            if o.dtype == torch.float64:
                self.findings.append(make_finding(
                    "NUM004", self._loc(),
                    f"float64 tensor produced by '{name}' in entry "
                    f"'{self.entry}'",
                    "keep device code f32; cast host-side doubles before "
                    "the entry"))

    def _check_reduce(self, name, args, kwargs, operand) -> None:
        dims = _dims(name, args, kwargs, operand.ndim)
        if dims is None:
            return
        frame = [d for d in dims if d < operand.ndim
                 and operand.shape[d] in self.frame_extents]
        if not frame:
            return
        tags = self.tag_of(operand)
        if "feats" in tags and "mask" not in tags:
            self.findings.append(make_finding(
                "NUM003", self._loc(),
                f"'{name}' reduces the frame axis (extent "
                f"{operand.shape[frame[0]]}) of a feature-derived value "
                "with no mask in its dataflow",
                "apply torch.where(mask, value, neutral) before the "
                "reduction"))

    def region(self, name, kernel, cfg, args, kw, out) -> None:
        in_tags: Set[str] = set()
        for t in list(tensors(args)) + list(tensors(kw)):
            in_tags |= self.tag_of(t)
        for o in tensors(out):
            self.seed(o, self.tag_of(o) | in_tags)


def check_dispatch(fn, *args, entry: Optional[str] = None,
                   input_roles: Optional[Sequence[Optional[str]]] = None,
                   frame_extent=None, **kwargs) -> List[Finding]:
    """Run ``fn(*args, **kwargs)`` under the walker and return its
    NUM001-NUM004 findings. The operands' device is where it runs.

    ``input_roles`` tags each positional argument (every tensor inside
    it) as 'feats', 'mask' or None; NUM003 activates only when a 'mask'
    role is present. ``frame_extent`` (int or iterable of ints) names the
    frame axis by size: pass a prime (and its flattened u*F multiple).
    """
    name = entry or getattr(fn, "__name__", "<fn>")
    if frame_extent is None:
        extents: Set[int] = set()
    elif isinstance(frame_extent, int):
        extents = {frame_extent}
    else:
        extents = set(frame_extent)
    roles = list(input_roles or ())
    walker = _Walker(name, extents, "mask" in roles)
    for role, a in zip(roles, args):
        if role in ("feats", "mask"):
            for t in tensors(a):
                walker.seed(t, walker.tag_of(t) | {role})
    with walker, torch.no_grad():
        fn(*args, **kwargs)
    return walker.findings
