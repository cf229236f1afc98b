"""Mamba-1 selective SSM layer (jamba's sequence mixer).

The port of ``repro/models/mamba.py``. The scan goes through
``ops.selective_scan`` at ``cfg.ssm.scan_dtype``: on the card the
hand-written kernel, which walks t in order with the state in registers
and takes and returns the state, so prefill and a decode step run the
same kernel; on the CPU its plain version. In f32 that is a sequential
scan, where the JAX ``_ssm_scan`` is chunked-associative: the same
function, summed in another order. At a 16-bit scan_dtype both follow the
reference's chunked tree and its roundings (``ref.selective_scan_tree``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.sharding import is_dtensor, tag

f32 = torch.float32


def dims(cfg):
    di = cfg.ssm.expand * cfg.d_model
    dtr = cfg.ssm.dt_rank or -(-cfg.d_model // 16)
    return di, dtr, cfg.ssm.d_state, cfg.ssm.d_conv


def mamba_table(cfg, prefix, lead) -> L.ParamTable:
    d = cfg.d_model
    di, dtr, ds, dc = dims(cfg)
    s = 0.02
    la = ("layers",) if lead else ()
    le = (lead,) if lead else ()
    return {
        prefix + "/in_proj": (le + (d, 2 * di), la + ("fsdp", "ffn"),
                              ("normal", s)),
        prefix + "/conv_w": (le + (di, dc), la + ("ffn", None),
                             ("normal", s)),
        prefix + "/conv_b": (le + (di,), la + ("ffn",), ("zeros",)),
        prefix + "/x_proj": (le + (di, dtr + 2 * ds), la + ("ffn", None),
                             ("normal", s)),
        prefix + "/dt_w": (le + (dtr, di), la + (None, "ffn"),
                           ("normal", s)),
        # softplus(-4.6) ~ 0.01
        prefix + "/dt_b": (le + (di,), la + ("ffn",), ("const", -4.6)),
        prefix + "/A_log": (le + (di, ds), la + ("ffn", None),
                            ("const", 0.0)),
        prefix + "/D": (le + (di,), la + ("ffn",), ("ones",)),
        prefix + "/out_proj": (le + (di, d), la + ("ffn", "fsdp"),
                               ("normal", s)),
    }


def _causal_conv(x, w, b, tail=None):
    """Depthwise causal conv via shifts. x: [B,T,di]; w: [di,dc]; tail:
    [B, dc-1, di] carry for decode/streaming (None -> zero history)."""
    B, T, di = x.shape
    dc = w.shape[1]
    if tail is None:
        tail = torch.zeros((B, dc - 1, di), dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)              # [B, T+dc-1, di]
    y = torch.zeros((B, T, di), dtype=f32, device=x.device)
    for i in range(dc):
        y = y + xp[:, i:i + T].to(f32) * w[:, i].to(f32)
    new_tail = xp[:, -(dc - 1):] if dc > 1 else tail
    return (y + b.to(f32)).to(x.dtype), new_tail


def _scan(dt, dx, A, Bc, Cc, h0, scan_dtype="float32"):
    """``ops.selective_scan`` at ``scan_dtype``; on DTensors each rank's
    kernel call on its local block under ``local_map``: channels split as
    dt's (the reference's 'ffn' over the model axis), batch as dt's, the
    time axis whole; A's gradient a partial sum over the batch split, B's
    and C's over the channel split."""
    if not is_dtensor(dt):
        return ops.selective_scan(dt, dx, A, Bc, Cc, h0, scan_dtype)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    tp = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
               for p in dt.placements)
    ap = tuple(Shard(0) if p == Shard(2) else Replicate() for p in tp)
    bp = tuple(Shard(0) if p == Shard(0) else Replicate() for p in tp)
    hp = tuple(Shard(1) if p == Shard(2) else p for p in tp)
    agrad = tuple(Partial() if p == Shard(0) else a for p, a in zip(tp, ap))
    bgrad = tuple(Partial() if p == Shard(2) else b for p, b in zip(tp, bp))
    hin = () if h0 is None else (h0,)

    def body(*args):
        return ops.selective_scan(*args[:5], args[5] if hin else None,
                                  scan_dtype)

    return local_map(
        body, out_placements=(tp, hp),
        in_placements=(tp, tp, ap, bp, bp) + ((hp,) if hin else ()),
        in_grad_placements=(tp, tp, agrad, bgrad, bgrad)
        + ((hp,) if hin else ()),
        device_mesh=dt.device_mesh, redistribute_inputs=True)(
            dt, dx, A, Bc, Cc, *hin)


def mamba_mix(cfg, p, x, state=None):
    """x: [B,T,d]. state: None or (conv_tail, h) for decode/streaming.
    Returns (y [B,T,d], (new_tail, h_last)), h_last in x's dtype."""
    di, dtr, ds, dc = dims(cfg)
    B, T, d = x.shape
    xz = L.mm(x, p["in_proj"].to(x.dtype))
    if is_dtensor(xz):
        # the halves' channels interleave over the ranks' blocks of the
        # 'ffn' split: gather it, take the halves, split each again
        xz = L.whole(xz, -1)
        x1 = tag(xz[..., :di], "batch", "seq", "ffn")
        z = tag(xz[..., di:], "batch", "seq", "ffn")
    else:
        x1, z = xz[..., :di], xz[..., di:]
    tail = state[0] if state is not None else None
    x1, new_tail = _causal_conv(x1, p["conv_w"], p["conv_b"], tail)
    x1 = F.silu(x1.to(f32)).to(x.dtype)
    proj = L._f32_dot(x1, p["x_proj"].to(x.dtype))
    dt_r, Bc, Cc = (proj[..., :dtr], proj[..., dtr:dtr + ds],
                    proj[..., dtr + ds:])
    dt = F.softplus(L.mm(dt_r, p["dt_w"].to(f32)) + p["dt_b"].to(f32))
    A = -torch.exp(p["A_log"].to(f32))            # [di, ds]
    h0 = state[1].to(f32) if state is not None else None
    x1f = x1.to(f32)
    y, h_last = _scan(dt, dt * x1f, A, Bc, Cc, h0, cfg.ssm.scan_dtype)
    y = y + p["D"].to(f32) * x1f
    y = y * F.silu(z.to(f32))
    out = L.mm(y.to(x.dtype), p["out_proj"].to(x.dtype))
    return out, (new_tail, h_last.to(x.dtype))


def state_struct(cfg, batch, dtype, lead):
    """{'conv', 'h'}: (shape, dtype) of one layer's (or ``lead`` stacked
    layers') decode state."""
    di, dtr, ds, dc = dims(cfg)
    le = (lead,) if lead else ()
    return {"conv": (le + (batch, dc - 1, di), dtype),
            "h": (le + (batch, di, ds), dtype)}
