"""Shared op-table for the port's program walkers (the counterpart of
``repro/analysis/optable.py``, reduced to what the port reads).

Two consumers walk the aten ops a call dispatches and must agree on what
an op is: ``analysis/op_cost.py`` (flops and bytes) and
``analysis/check/dispatch_pass.py`` (the numerics rules NUM001-NUM004).
Dtype widths, the contraction and LU-family op names and the collective
kinds that ``launch/mesh.py`` counts live here, so the cost model and the
lint cannot diverge.
"""
from __future__ import annotations

import torch

# bytes an element, by dtype name (the registry's ``work`` and ``bound``
# speak in names: "float32", "bfloat16", ...)
DTYPE_BYTES = {
    "float64": 8, "float32": 4, "float16": 2, "bfloat16": 2,
    "float8_e4m3fn": 1, "float8_e5m2": 1, "int64": 8, "int32": 4,
    "int16": 2, "int8": 1, "uint8": 1, "bool": 1, "complex64": 8,
    "complex128": 16,
}

# dtypes whose accumulation must be widened explicitly
LOW_PRECISION_DTYPES = frozenset(
    {torch.bfloat16, torch.float16, torch.float8_e4m3fn, torch.float8_e5m2})


def dtype_name(dtype: torch.dtype) -> str:
    """torch.float32 -> "float32"."""
    return str(dtype).removeprefix("torch.")


# the collectives ``launch/mesh.py`` runs and DTensor's functional ones
# (``Mesh.by_op`` counts their bytes by these names) and how often each
# crosses the links: an all-reduce twice (reduce-scatter, then
# all-gather), the others once
LINK_CROSSINGS = {"all-gather": 1, "all-reduce": 2, "reduce-scatter": 1,
                  "all-to-all": 1, "collective-permute": 1}

# DTensor's functional collectives (namespace ``_c10d_functional``) by the
# names ``Mesh.by_op`` counts them under
FUNCTIONAL_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all"}

# every torch.mm / matmul / einsum / linear lands on one of these aten ops
CONTRACTION_OPS = frozenset({
    "mm", "addmm", "bmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot",
    "_scaled_mm"})

# the LU family (a pivoted LU underneath): what NUM002 bans from entry
# points; Cholesky, triangular solves and eigh are the sanctioned path.
# Matched after ``base_name`` drops a leading '_' and a trailing '_ex'.
LU_FAMILY_OPS = frozenset({
    "linalg_solve", "linalg_inv", "linalg_lu_factor", "linalg_slogdet",
    "linalg_det", "linalg_lu", "linalg_lu_solve", "lu_solve"})

# axis-carrying reductions: what NUM003 inspects for unmasked frame folds
REDUCE_OPS = frozenset({
    "sum", "mean", "nansum", "amax", "amin", "max", "min", "argmax",
    "argmin", "prod", "logsumexp", "any", "all", "var", "std"})


def op_name(func) -> str:
    """An aten OpOverload's name without namespace or overload:
    aten.sum.dim_IntList -> "sum"."""
    return func._schema.name.split("::")[-1]


def base_name(name: str) -> str:
    """``op_name`` without a leading '_' or a trailing '_ex':
    _linalg_solve_ex -> linalg_solve."""
    return name.lstrip("_").removesuffix("_ex")
