"""AdamW with configurable moment dtypes, global-norm clipping and a
linear-warmup / cosine schedule: the port of ``repro/optim/adamw.py``.

Trees are flat ``{name: tensor}`` dicts (the LM params); the arithmetic
is f32 throughout, params cast back to their dtype and moments to the
moment dtype, as in the JAX package. The update is plain tensor code (it
is jnp there, not a kernel) and returns new tensors: the state it was
given is left as it was. A leaf is updated in slices along its leading
axis (``UPDATE_SLICE``): the arithmetic is elementwise, so the result is
the same bits, and the f32 temporaries stay one slice's size.

On a mesh the params are DTensors: each gradient is redistributed to its
param's placements, the moments take the same placements, the update
runs on each rank's local blocks, and the norm is the global one (each
leaf's sum of squares reduced over the mesh, then summed in leaf order).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch

f32 = torch.float32
# the most elements of a leaf updated at once (a row of the leading axis at
# least): the update keeps about five f32 temporaries of a slice alive,
# which for a whole stacked MoE table (738 M elements at Moonlight's 4
# layers) would be 15 GB beside two train states
UPDATE_SLICE = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    moment_dtype: str = "float32"


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def zeros_like(p, dtype):
    """Zeros of p's shape in ``dtype``, with p's placements on a mesh."""
    if _is_dtensor(p):
        return _like(p, torch.zeros_like(p.to_local(), dtype=dtype))
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def _local(t):
    return t.to_local() if _is_dtensor(t) else t


def adamw_init(params: Dict[str, torch.Tensor], oc: AdamWConfig) -> Dict:
    """Zero moments in ``oc.moment_dtype`` (with each param's placements
    on a mesh) and an int32 step count, on the params' device."""
    dt = getattr(torch, oc.moment_dtype)

    def zeros():
        return {k: zeros_like(p, dt) for k, p in params.items()}
    dev = next(iter(params.values())).device
    return {"m": zeros(), "v": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in f32, the leaves
    in sorted-name order (``jax.tree.leaves``' order)."""
    tot = None
    for k in sorted(tree):
        s = torch.sum(torch.square(tree[k].to(f32)))
        if _is_dtensor(s):
            s = s.full_tensor()
        tot = s if tot is None else tot + s
    return torch.sqrt(tot)


def _schedule(oc: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up over ``warmup_steps``, then cosine from ``lr`` to a
    tenth of it at ``total_steps``; f32."""
    step = step.to(f32)
    warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - oc.warmup_steps)
                       / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return oc.lr * warm * (0.1 + 0.9 * cos)


def _slices(p: torch.Tensor) -> list:
    """Index slices of ``p`` along its leading axis, each of at most
    ``UPDATE_SLICE`` elements (or one row); the whole of a small leaf."""
    if p.dim() == 0 or p.numel() <= UPDATE_SLICE:
        return [...]
    step = max(1, UPDATE_SLICE // (p.numel() // p.shape[0]))
    return [slice(i, i + step) for i in range(0, p.shape[0], step)]


def _like(p, local):
    """A DTensor of p's shape and placements over ``local`` blocks."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, p.device_mesh, p.placements,
                              shape=p.shape, stride=p.stride())


def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], opt_state: Dict,
                 oc: AdamWConfig):
    """Returns (new_params, new_opt_state, metrics {grad_norm, lr})."""
    grads = {k: (g.redistribute(params[k].device_mesh, params[k].placements)
                 if _is_dtensor(g) else g) for k, g in grads.items()}
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = _schedule(oc, count)
    c1 = 1.0 - torch.pow(torch.tensor(oc.b1, dtype=f32,
                                      device=count.device), count.to(f32))
    c2 = 1.0 - torch.pow(torch.tensor(oc.b2, dtype=f32,
                                      device=count.device), count.to(f32))
    new_p, new_m, new_v = {}, {}, {}
    for k in sorted(params):
        p, m, v = (_local(params[k]), _local(opt_state["m"][k]),
                   _local(opt_state["v"][k]))
        gk = _local(grads[k])
        new_p[k], new_m[k], new_v[k] = (torch.empty_like(p),
                                        torch.empty_like(m),
                                        torch.empty_like(v))
        for sl in _slices(p):
            g = gk[sl].to(f32) * scale
            m2 = oc.b1 * m[sl].to(f32) + (1 - oc.b1) * g
            v2 = oc.b2 * v[sl].to(f32) + (1 - oc.b2) * torch.square(g)
            step_ = (m2 / c1) / (torch.sqrt(v2 / c2) + oc.eps)
            p32 = p[sl].to(f32)
            new_p[k][sl] = (p32 - lr * (step_ + oc.weight_decay * p32)).to(
                p.dtype)
            new_m[k][sl], new_v[k][sl] = m2.to(m.dtype), v2.to(v.dtype)
        if _is_dtensor(params[k]):
            new_p[k], new_m[k], new_v[k] = (
                _like(params[k], new_p[k]), _like(params[k], new_m[k]),
                _like(params[k], new_v[k]))
    return (new_p, {"m": new_m, "v": new_v, "count": count},
            {"grad_norm": gnorm, "lr": lr})
