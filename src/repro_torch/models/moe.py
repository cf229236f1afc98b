"""Mixture-of-Experts FFN: GShard-style capacity dispatch on one device.

The port of ``repro/models/moe.py``'s dense path: top-k routing with the
GShard auxiliary loss, each (token, choice) given a slot in its expert's
buffer of ``cap`` rows in (token, choice) order, the rows past ``cap``
dropped (they add zero; Arctic's dense residual branch keeps them on the
gradient path), the experts' MLPs as bf16-in, f32-accumulated batched
products over [E, cap, d], and the kept rows gathered back and weighted.

Moving rows in and out of the expert buffers is ``_Rows``: a gather
whose backward is a gather too (each row's gradient collected from its
fixed set of destinations and summed in choice order), so a training
step repeats bitwise on the card without atomics. No index outside the
buffers reaches a gather: a dropped (token, choice) points at a zero row
appended for the purpose.

``capacity = max(1, int(T K cf / E))`` counts the tokens of the call, as
in the reference: a decode step (T = batch) drops choices that a prefill
of the same tokens keeps. ``moe_a2a``, the reference's expert-parallel
``shard_map`` over a mesh, is ROADMAP.md Queue 1 item 14g: until the
port has sharding rules, ``moe_ffn`` is ``moe_dense``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

f32 = torch.float32


def moe_table(cfg, prefix, nl) -> L.ParamTable:
    m = cfg.moe
    d, ff, E = cfg.d_model, m.d_ff_expert, m.n_experts
    s = 0.02
    gated = cfg.mlp_variant in ("swiglu", "geglu")
    t = {
        prefix + "/router": ((nl, d, E), ("layers", "dmodel", None),
                             ("normal", s)),
        prefix + "/w_up": ((nl, E, d, ff), ("layers", "experts", "fsdp",
                                            None), ("normal", s)),
        prefix + "/w_down": ((nl, E, ff, d), ("layers", "experts", None,
                                              "fsdp"), ("normal", s)),
    }
    if gated:
        t[prefix + "/w_gate"] = ((nl, E, d, ff), ("layers", "experts",
                                                  "fsdp", None),
                                 ("normal", s))
    return t


def _expert_mlp(cfg, p, h):
    """h: [E, C, d] -> [E, C, d], batched over experts, every product in
    h's dtype (bf16 on the card: f32 accumulation, bf16 result, as the
    reference's einsums without ``preferred_element_type``)."""
    dt = h.dtype
    up = torch.bmm(h, p["w_up"].to(dt))
    if cfg.mlp_variant in ("swiglu", "geglu"):
        gf = torch.bmm(h, p["w_gate"].to(dt)).to(f32)
        act = (F.silu(gf) if cfg.mlp_variant == "swiglu"
               else F.gelu(gf, approximate="tanh")).to(dt)
        hidden = act * up
    elif cfg.mlp_variant == "relu2":
        hidden = torch.square(torch.relu(up))
    else:
        hidden = F.gelu(up.to(f32), approximate="tanh").to(dt)
    return torch.bmm(hidden.to(dt), p["w_down"].to(dt))


def _route(cfg, p, x2d):
    """x2d: [T, d] -> (weights [T, K] f32, idx [T, K] int64, aux scalar).

    Router logits summed in f32; the top k of the softmax taken by a
    stable descending sort, so ties go to the lowest expert index, as
    ``lax.top_k``'s; the weights renormalised over the k. The GShard aux
    loss is E x mean over experts of (share of tokens whose first choice
    it is) x (mean router probability)."""
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    logits = L._f32_dot(x2d, p["router"].to(x2d.dtype))
    probs = torch.softmax(logits, dim=-1)
    idx = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :K]
    w = probs.gather(-1, idx)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # the share of first choices (a one-hot compare: F.one_hot checks its
    # input's range on the host, a sync a layer)
    frac = (idx[:, :1] == torch.arange(E, device=idx.device)).to(f32).mean(0)
    aux = E * torch.mean(frac * probs.mean(0))
    return w, idx, aux


def _positions_in_expert(idx, E: int):
    """idx: [T, K] expert choices -> the slot of each (t, k) within its
    expert, counted in (t, k) order (t-major, k-minor). [T, K] int64.

    The reference's running count over a [T K, E] one-hot, by a stable
    sort instead: within an expert the sort keeps (t, k) order, so a
    choice's slot is its place in the sorted list less its expert's first
    place. (A cumsum down the one-hot's T K rows is a scan along the
    outer dimension, parallel over E columns only: slow on the card.)"""
    flat = idx.reshape(-1)
    sorted_e, order = torch.sort(flat, stable=True)
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=flat.device))
    pos = torch.empty_like(flat)
    pos[order] = (torch.arange(flat.numel(), device=flat.device)
                  - starts[sorted_e])
    return pos.reshape(idx.shape)


class _Rows(torch.autograd.Function):
    """out[i] = x[src[i]], with src[i] == len(x) giving a zero row;
    grad_x[j] = sum over c of grad_out[back[j, c]] (back[j, c] ==
    len(out) adds zero), summed in c order. ``back`` lists, for each row
    of x, every row of out that reads it: the gather's transpose, so the
    backward is a gather and a fixed-order sum."""

    @staticmethod
    def forward(ctx, x, src, back):
        ctx.save_for_backward(back)
        return torch.cat([x, x.new_zeros(1, x.shape[1])])[src]

    @staticmethod
    def backward(ctx, g):
        (back,) = ctx.saved_tensors
        gp = torch.cat([g, g.new_zeros(1, g.shape[1])])
        return gp[back].sum(1), None, None


def _slot_maps(idx, pos, keep, E: int, cap: int):
    """The dispatch's two index maps. ``slot`` [T, K]: the buffer row
    e * cap + pos of each (t, k), or E * cap (the zero row) where it is
    dropped. ``src`` [E * cap]: the (t, k) row t * K + k that fills each
    buffer row, or T * K (the zero row) where no choice fills it."""
    T, K = idx.shape
    n = E * cap
    slot = torch.where(keep, idx * cap + pos, torch.full_like(idx, n))
    # the dropped choices all write the one extra row n, cut off after
    src = torch.full((n + 1,), T * K, dtype=torch.long, device=idx.device)
    src.index_put_((slot.reshape(-1),),
                   torch.arange(T * K, device=idx.device))
    return slot, src[:n]


def moe_dense(cfg, p, x):
    """Capacity dispatch on one device. x: [B, S, d] (or [T, d]) ->
    (y of x's shape and dtype, aux loss f32 scalar)."""
    m = cfg.moe
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    T, d = x2d.shape
    E, K = m.n_experts, m.top_k
    cap = max(1, int(T * K * m.capacity_factor / E))
    w, idx, aux = _route(cfg, p, x2d)
    with torch.no_grad():
        pos = _positions_in_expert(idx, E)
        slot, src = _slot_maps(idx, pos, pos < cap, E, cap)
        tok = torch.where(src < T * K, src // K, torch.full_like(src, T))
    # dispatch: buffer row s reads token src[s] // K; token t's rows are
    # its K slots (the zero row where dropped)
    buf = _Rows.apply(x2d, tok, slot).reshape(E, cap, d)
    y_buf = _expert_mlp(cfg, p, buf).reshape(E * cap, d)
    # combine: (t, k) reads its slot; buffer row s goes back to src[s]
    gathered = _Rows.apply(y_buf, slot.reshape(-1), src[:, None])
    y = (gathered.reshape(T, K, d) * w[..., None].to(x.dtype)).sum(1)
    return y.reshape(shape), aux


def moe_ffn(cfg, p, x, kind: str):
    """The dispatch selector: ``moe_dense``, the reference's choice
    wherever no sharding rules are active, as on one card. Its other
    choice, ``moe_a2a`` over a mesh, comes with the port's sharding rules
    (ROADMAP.md Queue 1 item 14g). ``kind`` is the reference's argument
    (train, prefill or decode), which only that choice reads."""
    return moe_dense(cfg, p, x)
