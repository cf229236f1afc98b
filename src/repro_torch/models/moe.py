"""Mixture-of-Experts FFN: GShard-style capacity dispatch, on one device
(``moe_dense``) and expert-parallel over a mesh (``moe_a2a``).

The port of ``repro/models/moe.py``. Its dense path: top-k routing with the
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
of the same tokens keeps.

``moe_a2a`` is the reference's expert-parallel ``shard_map`` body under
``local_map``: tokens split over every mesh axis, experts over 'model',
each rank's capacity buffer [P, E_loc, cap, d] laid out as
``moe_dense``'s [E, cap, d] (so the same ``_Rows`` dispatch fills it),
two counted ``launch.mesh.all_to_all`` exchanges, and the aux loss
averaged over every rank. ``moe_ffn`` picks it for train and prefill on
a mesh whose model axis the experts divide, as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.sharding import active_rules, is_dtensor

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


def _dispatch(cfg, x2d, router, cap: int):
    """Route the rows of x2d and fill the [E, cap, d] buffer -> (buf, w,
    slot, src, aux): buffer row s reads token src[s] // K; token t's rows
    are its K slots (the zero row where dropped)."""
    m = cfg.moe
    T, d = x2d.shape
    E, K = m.n_experts, m.top_k
    w, idx, aux = _route(cfg, {"router": router}, x2d)
    with torch.no_grad():
        pos = _positions_in_expert(idx, E)
        slot, src = _slot_maps(idx, pos, pos < cap, E, cap)
        tok = torch.where(src < T * K, src // K, torch.full_like(src, T))
    buf = _Rows.apply(x2d, tok, slot).reshape(E, cap, d)
    return buf, w, slot, src, aux


def _combine(y_buf, w, slot, src):
    """Each (t, k) reads its slot of the experts' output [E, cap, d]
    (buffer row s goes back to src[s]), weighted and summed over k ->
    [T, d]."""
    E, cap, d = y_buf.shape
    T, K = w.shape
    gathered = _Rows.apply(y_buf.reshape(E * cap, d), slot.reshape(-1),
                           src[:, None])
    return (gathered.reshape(T, K, d) * w[..., None].to(y_buf.dtype)).sum(1)


def _moe_dense_sharded(cfg, p, x):
    """``moe_dense`` on DTensors (decode on a mesh): the tokens replicated
    (one token a sequence), the routing and the buffer's rows moved on
    each rank's full copy under ``local_map``, the experts' products as
    DTensor ops on the experts' own placements (no gather of the expert
    tables), the buffer gathered back for the combine."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    m = cfg.moe
    dm = x.device_mesh
    rep = tuple(Replicate() for _ in range(dm.ndim))
    shape = x.shape
    T = x.numel() // shape[-1]
    cap = max(1, int(T * m.top_k * m.capacity_factor / m.n_experts))
    xr = x.redistribute(dm, rep).reshape(T, shape[-1])
    buf, w, slot, src, aux = local_map(
        lambda a, r: _dispatch(cfg, a, r, cap), out_placements=(rep,) * 5,
        in_placements=(rep, rep), device_mesh=dm,
        redistribute_inputs=True)(xr, p["router"])
    y_buf = _expert_mlp(cfg, p, buf)
    y = local_map(_combine, out_placements=list(rep),
                  in_placements=(rep,) * 4,
                  device_mesh=dm, redistribute_inputs=True)(
                      y_buf, w, slot, src)
    return y.reshape(shape), aux


def moe_dense(cfg, p, x):
    """Capacity dispatch on one device. x: [B, S, d] (or [T, d]) ->
    (y of x's shape and dtype, aux loss f32 scalar)."""
    if is_dtensor(x):
        return _moe_dense_sharded(cfg, p, x)
    m = cfg.moe
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    cap = max(1, int(x2d.shape[0] * m.top_k * m.capacity_factor
                     / m.n_experts))
    buf, w, slot, src, aux = _dispatch(cfg, x2d, p["router"], cap)
    y = _combine(_expert_mlp(cfg, p, buf), w, slot, src)
    return y.reshape(shape), aux


class _MeanAll(torch.autograd.Function):
    """The mean of a scalar over every rank (the reference's ``pmean``
    over all axes): an all-reduce forward; the result is the same on
    every rank, so each rank's share of its gradient is 1/N of it."""

    @staticmethod
    def forward(ctx, a, mesh):
        import torch.distributed as dist
        from repro_torch.launch.mesh import all_reduce
        ctx.n = mesh.size
        return all_reduce(mesh, a.clone(), dist.group.WORLD, "moe") / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _GatherSeq(torch.autograd.Function):
    """The model-axis blocks of the sequence put back together (the
    reference's tiled ``all_gather`` over 'model', dim 1); the result is
    the same on every model rank, so a rank's gradient is its block of
    the result's."""

    @staticmethod
    def forward(ctx, y, mesh):
        from repro_torch.launch.mesh import all_gather
        ctx.r, ctx.s = mesh.model_rank, y.shape[1]
        return torch.cat(all_gather(mesh, y, mesh.groups["model"], "moe"),
                         dim=1)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.r * ctx.s:(ctx.r + 1) * ctx.s], None


def moe_a2a(cfg, p, x, sp: bool):
    """Expert-parallel MoE over the active rules' mesh. x: [B, S, d]
    (a DTensor) -> (y of x's shape, aux loss, the same on every rank).

    sp=True: the caller's residual stream is sequence-parallel, tokens
    split over (data axes on the batch, 'model' on the sequence); the
    only collectives are the two exchanges. sp=False (jamba: its
    recurrence keeps the sequence whole): tokens arrive split over the
    data axes; each model rank takes its block of the sequence and the
    blocks are gathered back at the end."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.launch.mesh import all_to_all
    rules = active_rules()
    mesh = rules.mesh
    m = cfg.moe
    B, S, d = x.shape
    data_axes = tuple(a for a in mesh.axis_names if a != "model")
    Pm = mesh.sizes["model"]
    E = m.n_experts
    E_loc = E // Pm
    n_data = mesh.size // Pm
    t_loc = (B // n_data) * (S // Pm)
    # per-source-device, per-expert capacity
    cap = max(1, int(-(-t_loc * m.top_k * m.capacity_factor // E)))
    group = mesh.groups["model"]
    gated = cfg.mlp_variant in ("swiglu", "geglu")
    names = ("w_up", "w_down") + (("w_gate",) if gated else ())

    def block(x_blk, router, *ws):
        pp = dict(zip(names, ws))
        if not sp:
            s_loc = x_blk.shape[1] // Pm
            r = mesh.model_rank
            xs = x_blk[:, r * s_loc:(r + 1) * s_loc]
        else:
            xs = x_blk
        buf, w, slot, src, aux = _dispatch(cfg, xs.reshape(-1, d), router,
                                           cap)
        # the send buffer: peer p's experts' slots, [Pm, E_loc, cap, d]
        recv = all_to_all(mesh, buf.reshape(Pm, E_loc * cap, d), group,
                          "moe")
        h = recv.reshape(Pm, E_loc, cap, d).transpose(0, 1).reshape(
            E_loc, Pm * cap, d)
        y = _expert_mlp(cfg, pp, h)
        y = y.reshape(E_loc, Pm, cap, d).transpose(0, 1).reshape(
            Pm, E_loc * cap, d)
        back = all_to_all(mesh, y, group, "moe").reshape(E, cap, d)
        y_tok = _combine(back, w, slot, src).reshape(xs.shape)
        if not sp:
            y_tok = _GatherSeq.apply(y_tok, mesh)
        return y_tok, _MeanAll.apply(aux, mesh)

    tok_spec = rules.placements_of(
        (data_axes, "model" if sp else None, None))
    rep = tuple(Replicate() for _ in tok_spec)
    w_spec = rules.placements_of(("model", None, None))
    # each rank's gradients come from its own tokens: partial sums over
    # every axis a spec leaves whole (the reference's shard_map psums its
    # cotangents there); sp=False leaves x whole over 'model' and each
    # model rank's gradient covers only its block of the sequence
    tok_grad, w_grad = (tuple(p if isinstance(p, Shard) else Partial()
                              for p in spec) for spec in (tok_spec, w_spec))
    fn = local_map(block, out_placements=(tok_spec, rep),
                   in_placements=(tok_spec, rep) + (w_spec,) * len(names),
                   in_grad_placements=(tok_grad, (Partial(),) * len(rep))
                   + (w_grad,) * len(names),
                   device_mesh=rules.device_mesh, redistribute_inputs=True)
    return fn(x, p["router"], *(p[n] for n in names))


def moe_ffn(cfg, p, x, kind: str, sp: bool = False):
    """The dispatch selector, the reference's: ``moe_a2a`` for train and
    prefill on a mesh whose model axis (> 1) the experts divide, where
    the batch divides the data ranks and the sequence the model axis;
    ``moe_dense`` otherwise (one card, decode). ``sp`` holds only where
    the rules shard the residual's sequence."""
    m = cfg.moe
    rules = active_rules()
    B, S = x.shape[0], x.shape[1]
    sizes = rules.mesh.sizes if rules is not None else {}
    Pm = sizes.get("model", 1)
    if (rules is not None and rules.distributed and Pm > 1
            and kind in ("train", "prefill") and m.n_experts % Pm == 0
            and B % (rules.mesh.size // Pm) == 0 and S % Pm == 0):
        return moe_a2a(cfg, p, x,
                       sp and rules.table.get("seq_sp") is not None)
    return moe_dense(cfg, p, x)
