"""Shared neural-net layers: norms, RoPE, attention, MLP variants, embeddings.

The port of ``repro/models/layers.py``. Layers are plain functions over
flat ``{name: tensor}`` param dicts; param shapes come from the same
declarative tables (the JAX logical sharding axes are kept in the tables
but unused on one device). Where the JAX code asks a product for f32
output (``preferred_element_type=f32``), the port widens both operands to
f32 first: bf16 widens exactly and its products are exact in f32, so the
result is the same function.

The training loss (``softmax_xent``, ``chunked_lm_loss``) is ported; each
sequence chunk of the loss is recomputed in the backward pass
(``torch.utils.checkpoint``), as the JAX ``lax.scan`` over
``jax.checkpoint``-ed chunks does.

On a mesh (``sharding.use_rules`` with more than one rank) params and
activations are DTensors and ``tag`` redistributes them, as the
reference's ``with_sharding_constraint``. The hand-written kernels take
each rank's local block under ``local_map`` (``blockwise_causal_attention``
here, ``mamba.mamba_mix``'s scan); ``ring_attention`` is the reference's
context-parallel ``shard_map`` body, its kv blocks rotated by
``launch.mesh.ppermute_ring``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.sharding import active_rules, is_dtensor, tag, use_rules

f32 = torch.float32
_NEG = -1e30

# name -> (shape, logical_axes, init); init: ('normal', stddev) | ('zeros',)
# | ('ones',) | ('const', v) | ('uniform', lo, hi)
ParamTable = Dict[str, Tuple[Tuple[int, ...], Tuple, Tuple]]


# the most elements a table_init draw holds in f32 at once (1 GiB)
DRAW_SLICE = 1 << 28


def _draw(out, init, generator) -> None:
    """Fill ``out`` with ``init``'s values: drawn in f32 and written into
    out's dtype, in slices along the leading axis (recursively, where one
    slice is still over ``DRAW_SLICE`` elements)."""
    n = out.numel()
    if n > DRAW_SLICE and out.dim() > 1:
        step = DRAW_SLICE // (n // out.shape[0])
        for i in range(0, out.shape[0], max(step, 1)):
            # a row over the slice is cut along its own leading axis
            _draw(out[i:i + step] if step else out[i], init, generator)
        return
    kind, shape, dev = init[0], out.shape, out.device
    if kind == "normal":
        arr = torch.randn(shape, generator=generator, dtype=f32,
                          device=dev).mul_(init[1])
    elif kind == "zeros":
        arr = torch.zeros(shape, dtype=f32, device=dev)
    elif kind == "ones":
        arr = torch.ones(shape, dtype=f32, device=dev)
    elif kind == "const":
        arr = torch.full(shape, init[1], dtype=f32, device=dev)
    elif kind == "uniform":
        arr = torch.rand(shape, generator=generator, dtype=f32,
                         device=dev).mul_(init[2] - init[1]).add_(init[1])
    else:
        raise ValueError(kind)
    out.copy_(arr)


def table_init(table: ParamTable, generator: torch.Generator, dtype,
               device, place=None) -> Dict[str, torch.Tensor]:
    """Draw every param of ``table`` in sorted-name order from one
    generator, on ``device`` (the generator's device), in f32 cast to
    ``dtype``. Same distributions as the JAX ``table_init``; not the same
    numbers. A table over ``DRAW_SLICE`` elements is drawn slice by slice
    along its leading axes, so that its f32 draw costs one slice beside
    the result (Moonlight's stacked expert tables are 35 GB each in f32);
    one under it is one draw. ``place(name, tensor)``, where given, takes
    each whole param as it is drawn and returns what is kept of it (a
    rank's shard: one whole param is alive at a time)."""
    out = {}
    for name, (shape, _, init) in sorted(table.items()):
        t = torch.empty(shape, dtype=dtype, device=device)
        _draw(t, init, generator)
        out[name] = t if place is None else place(name, t)
        del t
    return out


def remat(fn, *args):
    """``fn(*args)``, recomputed in the backward pass instead of kept
    (``torch.utils.checkpoint``, non-reentrant). On a mesh the
    recomputation re-enters the active rules: on the card the backward
    runs on autograd's device thread, which does not see the caller's
    context variable, so the recomputation would take the one-rank paths
    and save other tensors than the forward did."""
    rules = active_rules()
    if rules is None or not rules.distributed:
        return checkpoint(fn, *args, use_reentrant=False)

    def again(*a):
        with use_rules(rules):
            return fn(*a)
    return checkpoint(again, *args, use_reentrant=False)


def whole(t, dim: int):
    """A DTensor with dim ``dim`` gathered whole on every rank (before a
    slice of that dim, which DTensor's rule for a split dim does not
    give the same answer for across torch versions)."""
    from torch.distributed.tensor import Replicate, Shard
    d = dim % t.dim()
    pl = [Replicate() if p == Shard(d) else p for p in settle(t).placements]
    return t.redistribute(t.device_mesh, pl)


def settle(t):
    """A DTensor's partial reductions (a max or a sum over a split dim)
    carried out now: its Partial placements made Replicate. DTensor
    cannot turn a partial max into the partial sum a following
    subtraction would want; a plain tensor is returned as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Partial, Replicate
    if not any(isinstance(p, Partial) for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in t.placements])


def _f32_dot(x, w):
    """x [..., K] @ w [K, N] with f32 output, as JAX's
    ``preferred_element_type=f32``."""
    return mm(x.to(f32), w.to(f32))


def mm(x, w):
    """x [..., K] @ w [K, N]; on DTensors ``dmatmul``."""
    if is_dtensor(x) and is_dtensor(w):
        return dmatmul(x, w, 1)
    return x @ w


def dmatmul(x, w, nk: int):
    """x [*L, *K] times w [*K, *N] -> [*L, *N] on DTensors, K the first
    ``nk`` dims of w: each rank's product of its blocks under
    ``local_map``, placed as GSPMD places the reference's einsum. Per
    mesh axis: x split on a leading dim keeps it (w gathered whole there,
    the fsdp gather; w's gradient a partial sum); else w split on an
    output dim keeps it (x gathered; x's gradient partial); x and w split
    on the same contracted dim, or w alone on one (x then sliced
    locally), give a partial sum; x partial stays partial; else both
    whole. No DTensor is reshaped, so no split is flattened into
    another (DTensor's own product rule flattens [B, S] and may split a
    product's columns finer than its heads)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    R = Replicate()
    nl = x.dim() - nk
    xin, win, out, xg, wg = [], [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        xd = xp.dim if isinstance(xp, Shard) else None
        wd = wp.dim if isinstance(wp, Shard) else None
        if isinstance(xp, Partial) and wd is None:
            row = (xp, R, xp, R, Partial())
        elif xd is not None and xd < nl:
            row = (Shard(xd), R, Shard(xd), Shard(xd), Partial())
        elif wd is not None and wd >= nk:
            row = (R, Shard(wd), Shard(nl + wd - nk), Partial(), Shard(wd))
        elif wd is not None and (xd == nl + wd or
                                 (xd is None and not isinstance(xp,
                                                                Partial))):
            row = (Shard(nl + wd), Shard(wd), Partial(), Shard(nl + wd),
                   Shard(wd))
        else:
            row = (R, R, R, R, R)
        for lst, pl in zip((xin, win, out, xg, wg), row):
            lst.append(pl)

    def body(xl, wl):
        kk = 1
        for n in wl.shape[:nk]:
            kk *= n
        lead = xl.shape[:nl]
        y = xl.reshape(lead + (kk,)) @ wl.reshape(kk, -1)
        return y.reshape(lead + wl.shape[nk:])

    return local_map(body, out_placements=out,
                     in_placements=(tuple(xin), tuple(win)),
                     in_grad_placements=(tuple(xg), tuple(wg)),
                     device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, w)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x, scale):
    xf = x.to(f32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * (1.0 + scale.to(f32))).to(x.dtype)


def layernorm(x, scale, bias):
    xf = x.to(f32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + 1e-5)
    return (y * (1.0 + scale.to(f32)) + bias.to(f32)).to(x.dtype)


def norm(cfg, params, prefix, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, params[prefix + "/scale"])
    return layernorm(x, params[prefix + "/scale"], params[prefix + "/bias"])


def norm_table(cfg, prefix, stacked_layers=0) -> ParamTable:
    d = cfg.d_model
    lead = (stacked_layers,) if stacked_layers else ()
    lax_ = ("layers",) if stacked_layers else ()
    t = {prefix + "/scale": (lead + (d,), lax_ + ("dmodel",), ("zeros",))}
    if cfg.norm == "layernorm":
        t[prefix + "/bias"] = (lead + (d,), lax_ + ("dmodel",), ("zeros",))
    return t


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x, positions, theta):
    """x: [..., S, H, hd]; positions: [S] or [B, S] (broadcast over heads)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=f32, device=x.device)
                     / half)
    ang = positions.to(f32)[..., None] * freq      # [..., S, half]
    cos = torch.cos(ang)[..., None, :]             # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(f32), x[..., half:].to(f32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _local_kv(k, v, h0: int, h_loc: int, G: int):
    """The kv heads a rank's query heads [h0, h0 + h_loc) read, from k
    and v holding all KVH heads: a slice where the rank's heads cover
    whole groups or sit in one, else one kv head per query head."""
    if h_loc % G == 0 and h0 % G == 0:
        sl = slice(h0 // G, (h0 + h_loc) // G)
        return k[:, :, sl], v[:, :, sl]
    if G % h_loc == 0:
        sl = slice(h0 // G, h0 // G + 1)
        return k[:, :, sl], v[:, :, sl]
    idx = torch.arange(h0, h0 + h_loc, device=k.device) // G
    return k[:, :, idx], v[:, :, idx]


def _sharded_attention(q, k, v, fn=None):
    """``ops.flash_attention`` (or ``fn``) on DTensors: each rank's call on
    its local block under ``local_map``. Batch follows q's data placements;
    where q's heads are sharded over a mesh axis and k's are not (too few
    kv heads), a rank reads the kv heads its query heads need, and k's
    and v's gradients come back as partial sums over that axis."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    dm = q.device_mesh
    H, KVH = q.shape[2], k.shape[2]
    G = H // KVH
    # batch and heads split as q's; the sequence whole (causality)
    qp = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
               for p in q.placements)
    # k and v follow q outside the heads dim; their heads stay as they are
    kvp = tuple(p if p != Shard(2) else
                (Shard(2) if k.placements[i] == Shard(2) else Replicate())
                for i, p in enumerate(qp))
    head_dims = [i for i, p in enumerate(qp) if p == Shard(2)
                 and kvp[i] == Replicate()]
    kv_grad = tuple(Partial() if i in head_dims else p
                    for i, p in enumerate(kvp))

    def body(ql, kl, vl):
        if head_dims:
            h_loc = ql.shape[2]
            r = 0
            for i in head_dims:
                r = r * dm.size(i) + dm.get_local_rank(i)
            kl, vl = _local_kv(kl, vl, r * h_loc, h_loc, G)
        return (fn or ops.flash_attention)(ql, kl, vl)

    return local_map(body, out_placements=list(qp),
                     in_placements=(qp, kvp, kvp),
                     in_grad_placements=(qp, kv_grad, kv_grad),
                     device_mesh=dm, redistribute_inputs=True)(q, k, v)


def blockwise_causal_attention(q, k, v):
    """Causal GQA attention, q: [B, S, H, hd]; k, v: [B, S, KVH, hd].

    On the card this is the hand-written flash-attention kernel, on the
    CPU its plain version (``ops.flash_attention``). Both keep p to f32
    precision before P.V (the bf16 kernel as a bf16 hi and lo pair, to
    about 2^-16); the JAX blockwise path casts p to q's dtype first, so
    at bf16 the port follows the TPU kernel, and at f32 the two agree to
    rounding. On DTensors each rank runs it on its local block
    (``_sharded_attention``).
    """
    if is_dtensor(q):
        return _sharded_attention(q, k, v)
    return ops.flash_attention(q, k, v)


def _ring_step(qr, kc, vc, o, m, l, qpos, kpos, scale):
    """One kv block of the ring: the reference's online-softmax update,
    its einsums in f32 (p cast to q's dtype before P.V)."""
    s = torch.einsum("bqkgh,bskh->bqkgs", qr.to(f32), kc.to(f32)) * scale
    mask = qpos[:, None] >= kpos[None, :]
    s = torch.where(mask[None, :, None, None, :], s, _NEG)
    m2 = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m2[..., None])
    alpha = torch.exp(m - m2)
    l2 = l * alpha + p.sum(-1)
    o2 = o * alpha[..., None] + torch.einsum(
        "bqkgs,bskh->bqkgh", p.to(qr.dtype).to(f32), vc.to(f32))
    return o2, m2, l2


def ring_attention(q, k, v):
    """Context-parallel causal attention: q/k/v arrive SEQ-SHARDED over the
    'model' axis; kv blocks rotate around the ring (``ppermute_ring``)
    while each rank accumulates its q rows online (Ring Attention).

    Used when an arch's head count does not divide the model axis
    (arctic's 56, whisper's 20, internvl's 14): the ring keeps compute
    exact per rank and its only collective is the kv rotation.
    q: [B, S, H, hd]; k, v: [B, S, KVH, hd] (global shapes, DTensors).
    The body is the reference's ``shard_map`` body under ``local_map``
    with its specs (``P(data_axes, 'model', None, None)``); each step is
    recomputed in the backward pass, as the reference's checkpointed scan
    step. Every rank computes every step, the blocks wholly above its
    diagonal too (they add exactly nothing), as the reference does: a
    rank that left a block out would leave that rotation's backward
    permute out of its graph, and the other ranks would wait on it. The
    last rotation, whose blocks no rank reads, is not made."""
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.launch.mesh import ppermute_ring
    rules = active_rules()
    mesh = rules.mesh
    Pm = mesh.sizes["model"]
    data_axes = tuple(a for a in mesh.axis_names if a != "model")
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    S_loc = S // Pm
    scale = hd ** -0.5
    group = mesh.groups["model"]
    spec = rules.placements_of((data_axes, "model", None, None))

    def block(q_loc, k_loc, v_loc):
        r = mesh.model_rank
        Bl = q_loc.shape[0]
        dev = q_loc.device
        qr = q_loc.reshape(Bl, S_loc, KVH, G, hd)
        qpos = r * S_loc + torch.arange(S_loc, device=dev)
        o = torch.zeros((Bl, S_loc, KVH, G, hd), dtype=f32, device=dev)
        m = torch.full((Bl, S_loc, KVH, G), _NEG, dtype=f32, device=dev)
        l = torch.zeros((Bl, S_loc, KVH, G), dtype=f32, device=dev)
        kc, vc = k_loc, v_loc
        for j in range(Pm):
            src = (r - j) % Pm
            kpos = src * S_loc + torch.arange(S_loc, device=dev)
            o, m, l = checkpoint(_ring_step, qr, kc, vc, o, m, l, qpos,
                                 kpos, scale, use_reentrant=False)
            if j < Pm - 1:
                kc = ppermute_ring(mesh, kc, group, "ring")
                vc = ppermute_ring(mesh, vc, group, "ring")
        out = o / torch.clamp(l[..., None], min=1e-30)
        return out.reshape(Bl, S_loc, H, hd).to(q_loc.dtype)

    return local_map(block, out_placements=list(spec),
                     in_placements=(spec, spec, spec),
                     device_mesh=rules.device_mesh,
                     redistribute_inputs=True)(q, k, v)


def use_ring_attention(cfg, B: int, S: int) -> bool:
    """Ring path: active mesh, heads do NOT divide the model axis (so the
    head-sharded path would replicate), and batch/seq divide the mesh."""
    rules = active_rules()
    if rules is None or "model" not in rules.mesh.sizes:
        return False
    msize = rules.mesh.sizes["model"]
    if msize <= 1 or cfg.n_heads % msize == 0:
        return False
    n_data = rules.mesh.size // msize
    return S % msize == 0 and B % n_data == 0


def full_attention(q, k, v, causal: bool):
    """Plain GQA attention over a short kv (the whisper encoder and the
    cross-attention), causal or not. q: [B, Sq, H, hd]; k, v: [B, Sk,
    KVH, hd] -> [B, Sq, H, hd] in q's dtype.

    The JAX package computes it with ``einsum`` outside any Pallas
    kernel, so here it stays matmul and softmax on the card too. Scores
    in f32; p is cast to q's dtype before P.V (the reference's rounding,
    not the flash kernel's hi/lo pair), summed in f32. On DTensors each
    rank computes its block under ``local_map``, as the flash kernel's
    (``_sharded_attention``): DTensor's own einsum flattens split dims,
    which torch 2.11 refuses.
    """
    if is_dtensor(q):
        return _sharded_attention(
            q, k, v, lambda a, b, c: full_attention(a, b, c, causal))
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qr = q.reshape(B, Sq, KVH, G, hd)
    s = torch.einsum("bqkgh,bskh->bqkgs", qr.to(f32), k.to(f32)) * hd ** -0.5
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask[None, :, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskh->bqkgh", p.to(q.dtype).to(f32), v.to(f32))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def cache_write(cache, pos: int, new) -> None:
    """cache[:, pos] = new, in place: cache [B, S, KVH, hd], new [B, KVH,
    hd]. On a DTensor cache whose sequence is sharded, the rank whose
    block holds ``pos`` writes it into its local block (the reference's
    ``dynamic_update_slice`` into a sharded cache)."""
    if not is_dtensor(cache):
        cache[:, pos] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    dm, cp = cache.device_mesh, tuple(cache.placements)
    # new's dims are cache's without the sequence: batch 0, heads 1
    want = tuple(Replicate() if p == Shard(1) else
                 (Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1
                  else p) for p in cp)
    loc = cache.to_local()
    nl = new.redistribute(dm, want).to_local()
    r = 0
    for i, p in enumerate(cp):
        if p == Shard(1):
            r = r * dm.size(i) + dm.get_local_rank(i)
    s_loc = loc.shape[1]
    if r * s_loc <= pos < (r + 1) * s_loc:
        loc[:, pos - r * s_loc] = nl.to(loc.dtype)


def _sharded_decode_attention(q, k_cache, v_cache, pos: int):
    """``decode_attention`` on a DTensor cache split over batch, kv heads
    and/or sequence (the rules' 'cache_batch', 'kv_heads', 'cache_seq'):
    each rank attends to its block of the cache under ``local_map``
    (q split as the cache's batch and heads), giving its block's row max,
    sum and unnormalised output; the blocks of a split sequence are then
    combined as flash-decoding does (a max and two sums over the ranks)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    dm = k_cache.device_mesh
    B, S, KVH, hd = k_cache.shape
    G = q.shape[1] // KVH
    R = Replicate()
    cp = tuple(k_cache.placements)
    qp = tuple({Shard(0): Shard(0), Shard(2): Shard(1)}.get(p, R)
               for p in cp)
    op = tuple({Shard(0): Shard(1), Shard(1): Shard(0),
                Shard(2): Shard(2)}.get(p, R) for p in cp)
    seq_dims = [i for i, p in enumerate(cp) if p == Shard(1)]

    def body(ql, kl, vl):
        r = 0
        for i in seq_dims:
            r = r * dm.size(i) + dm.get_local_rank(i)
        b, s_loc, kvh = kl.shape[:3]
        qr = ql.reshape(b, kvh, G, hd)
        s = torch.einsum("bkgh,bskh->bkgs", qr.to(f32),
                         kl.to(f32)) * hd ** -0.5
        valid = r * s_loc + torch.arange(s_loc, device=ql.device) <= pos
        s = torch.where(valid[None, None, None, :], s, _NEG)
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        o = torch.einsum("bkgs,bskh->bkgh", p.to(ql.dtype).to(f32),
                         vl.to(f32))
        return m[None], p.sum(-1)[None], o[None]

    m, l, o = local_map(body, out_placements=(op, op, op),
                        in_placements=(qp, cp, cp), device_mesh=dm,
                        redistribute_inputs=True)(q, k_cache, v_cache)
    mx = settle(m.amax(0))
    w = torch.exp(m - mx[None])
    o = (o * w[..., None]).sum(0) / (l * w).sum(0)[..., None]
    return o.reshape(B, KVH * G, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos: int):
    """Single-token attention against a fixed-size cache.

    q: [B, H, hd]; caches: [B, S, KVH, hd]; pos: tokens < pos+1 are valid
    (the current token was already written at ``pos``). On DTensors
    ``_sharded_decode_attention``.
    """
    if is_dtensor(k_cache):
        return _sharded_decode_attention(q, k_cache, v_cache, pos)
    B, S, KVH, hd = k_cache.shape
    H = q.shape[1]
    G = H // KVH
    qr = q.reshape(B, KVH, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qr.to(f32),
                     k_cache.to(f32)) * hd ** -0.5
    valid = torch.arange(S, device=q.device) <= pos
    s = torch.where(valid[None, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(q.dtype).to(f32),
                     v_cache.to(f32))
    return o.reshape(B, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention projections (+tables)
# ---------------------------------------------------------------------------


def attn_table(cfg, prefix, L) -> ParamTable:
    d, H, KVH = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim()
    s = 0.02
    return {
        prefix + "/wq": ((L, d, H, hd),
                         ("layers", "fsdp", "heads", "head_dim"),
                         ("normal", s)),
        prefix + "/wk": ((L, d, KVH, hd),
                         ("layers", "fsdp", "kv_heads", "head_dim"),
                         ("normal", s)),
        prefix + "/wv": ((L, d, KVH, hd),
                         ("layers", "fsdp", "kv_heads", "head_dim"),
                         ("normal", s)),
        prefix + "/wo": ((L, H, hd, d),
                         ("layers", "heads", "head_dim", "fsdp"),
                         ("normal", s)),
    }


def _proj_heads(x, w):
    """x [B, S, d] @ w [d, H, hd] -> [B, S, H, hd] in x's dtype."""
    if is_dtensor(x):
        return dmatmul(x, w.to(x.dtype), 1)
    d, H, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, H * hd)).reshape(
        x.shape[:-1] + (H, hd))


def _f32_proj_heads(x, w):
    """x [B, S, d] @ w [d, H, hd] -> [B, S, H, hd] f32, as JAX's
    ``preferred_element_type=f32`` einsum."""
    if is_dtensor(x):
        return dmatmul(x.to(f32), w.to(f32), 1)
    d, H, hd = w.shape
    return _f32_dot(x, w.reshape(d, H * hd)).reshape(x.shape[:-1] + (H, hd))


def qkv_proj(cfg, p, x, positions=None, sp: bool = False):
    """x: [B, S, D] -> q [B,S,H,hd], k,v [B,S,KVH,hd] (+RoPE if positions).

    sp=True (ring-attention path): projections run on the seq-sharded
    residual and stay seq-sharded."""
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x, p["wk"])
    v = _proj_heads(x, p["wv"])
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    seq_ax = "seq_sp" if sp else "seq"
    q = tag(q, "batch", seq_ax, "heads", None)
    k = tag(k, "batch", seq_ax, "kv_heads", None)
    v = tag(v, "batch", seq_ax, "kv_heads", None)
    return q, k, v


def out_proj(p, o):
    """o [B, S, H, hd] @ wo [H, hd, d] -> [B, S, d] in o's dtype."""
    if is_dtensor(o):
        return dmatmul(o, p["wo"].to(o.dtype), 2)
    H, hd, d = p["wo"].shape
    return o.reshape(o.shape[:-2] + (H * hd,)) @ p["wo"].to(o.dtype).reshape(
        H * hd, d)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_table(cfg, prefix, L, d_ff=None) -> ParamTable:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    s = 0.02
    gated = cfg.mlp_variant in ("swiglu", "geglu")
    t = {
        prefix + "/w_up": ((L, d, ff), ("layers", "fsdp", "ffn"),
                           ("normal", s)),
        prefix + "/w_down": ((L, ff, d), ("layers", "ffn", "fsdp"),
                             ("normal", s)),
    }
    if gated:
        t[prefix + "/w_gate"] = ((L, d, ff), ("layers", "fsdp", "ffn"),
                                 ("normal", s))
    return t


def mlp(cfg, p, x):
    up = mm(x, p["w_up"].to(x.dtype))
    if cfg.mlp_variant == "swiglu":
        g = mm(x, p["w_gate"].to(x.dtype))
        h = F.silu(g.to(f32)).to(x.dtype) * up
    elif cfg.mlp_variant == "geglu":
        g = mm(x, p["w_gate"].to(x.dtype))
        h = F.gelu(g.to(f32), approximate="tanh").to(x.dtype) * up
    elif cfg.mlp_variant == "relu2":
        h = torch.square(torch.relu(up))
    elif cfg.mlp_variant == "gelu":
        h = F.gelu(up.to(f32), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(f"unknown mlp_variant {cfg.mlp_variant!r}")
    h = tag(h.to(x.dtype), "batch", "seq", "ffn")
    return mm(h, p["w_down"].to(x.dtype))


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def padded_vocab(V: int) -> int:
    """The vocab padded to a multiple of 128, as the JAX tables are."""
    return -(-V // 128) * 128


def embed_table(cfg) -> ParamTable:
    V, d = padded_vocab(cfg.vocab_size), cfg.d_model
    t = {"embed": ((V, d), ("vocab", "dmodel"), ("normal", 0.02))}
    if not cfg.tie_embeddings:
        t["unembed"] = ((d, V), ("fsdp", "vocab"), ("normal", 0.02))
    return t


def _sharded_lookup(table, tokens):
    """table[tokens] on DTensors, the table's vocab rows split over mesh
    axes (the reference's 'vocab' axis): each rank looks up the tokens
    its rows hold (zeros for the others) under ``local_map``, so the
    result is a partial sum over those axes and the table is never
    gathered. The tokens keep their own split elsewhere."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    dm = table.device_mesh
    R = Replicate()
    tin, pin, out, pg = [], [], [], []
    vocab = []
    for i, (tp, kp) in enumerate(zip(table.placements, tokens.placements)):
        if tp == Shard(0):
            row = (R, Shard(0), Partial(), Shard(0))
            vocab.append(i)
        elif isinstance(kp, Shard):
            row = (kp, R, kp, Partial())
        else:
            row = (R, R, R, R)
        for lst, pl in zip((tin, pin, out, pg), row):
            lst.append(pl)

    def body(tl, kl):
        r = 0
        for i in vocab:
            r = r * dm.size(i) + dm.get_local_rank(i)
        n = tl.shape[0]
        idx = kl.long() - r * n
        hit = (idx >= 0) & (idx < n)
        rows = tl[torch.where(hit, idx, torch.zeros_like(idx))]
        return rows * hit[..., None].to(rows.dtype)

    return local_map(body, out_placements=out,
                     in_placements=(tuple(pin), tuple(tin)),
                     in_grad_placements=(tuple(pg), tuple(tin)),
                     device_mesh=dm, redistribute_inputs=True)(table, tokens)


def embed(cfg, params, tokens):
    table = params["embed"]
    if is_dtensor(table):
        e = _sharded_lookup(table, tokens).to(cfg_dtype(cfg))
        # rows of one token (RWKV's decode) are [B, d]
        return tag(e, *(("batch", "seq", None) if e.dim() == 3
                        else ("batch", None)))
    return table[tokens].to(cfg_dtype(cfg))


def logits_fn(cfg, params, x):
    """f32 logits over the REAL vocab (padded columns sliced off)."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = tag(_f32_dot(x, w.to(x.dtype)), "batch", "seq", "vocab")
    if is_dtensor(logits):      # the slice takes the vocab split whole
        logits = whole(logits, -1)
    return logits[..., :cfg.vocab_size]


def _label_select(shifted, labels):
    """Each row's ``shifted`` logit at its label, in the JAX comparison
    form (iota == label, then a sum over the vocab): no gather, whose
    backward would be a float scatter-add."""
    V = shifted.shape[-1]
    iota = torch.arange(V, device=shifted.device, dtype=labels.dtype)
    return torch.where(iota == labels[..., None], shifted, 0.0).sum(-1)


def _log_sum_exp(shifted):
    """log(sum(exp(shifted), -1)). Over a split vocab the sum is a partial
    one, settled before the log: left to DTensor, the log's backward on a
    mesh of two split axes came out wrong in torch 2.11 (a (2, 2) world
    of gloo ranks on an H100), while its forward agreed."""
    return torch.log(settle(torch.exp(shifted).sum(-1)))


def softmax_xent(logits, labels, mask=None):
    """Sharded-vocab-safe cross-entropy: no gather over the vocab dim.

    logits: [B, S, V] f32; labels: [B, S] int; mask: [B, S] (1 = count).
    """
    lmax = settle(logits.amax(-1, keepdim=True)).detach()
    shifted = logits - lmax
    lse = _log_sum_exp(shifted) + lmax[..., 0]
    nll = lse - (settle(_label_select(shifted, labels)) + lmax[..., 0])
    if mask is None:
        return nll.mean()
    mask = mask.to(f32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _chunk_nll(cfg, xc, w, lc, mc):
    """One sequence chunk of ``chunked_lm_loss``: its logits (padded vocab
    columns at -1e30), then (masked NLL sum, token count)."""
    logits = tag(_f32_dot(xc, w), "batch", "seq", "vocab")
    V = logits.shape[-1]
    if V != cfg.vocab_size:                   # mask padded vocab columns
        pad = torch.arange(V, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad, _NEG, logits)
    lmax = settle(logits.amax(-1, keepdim=True)).detach()
    shifted = logits - lmax
    lse = _log_sum_exp(shifted) + lmax[..., 0]
    nll = lse - (settle(_label_select(shifted, lc)) + lmax[..., 0])
    mc = mc.to(f32)
    return (nll * mc).sum(), mc.sum()


def chunked_lm_loss(cfg, params, x, labels, mask=None, chunk=512):
    """LM cross-entropy without materializing [B, S, V] logits.

    Sequence chunks of ``chunk`` (all of S where S is not a multiple of
    it); each chunk computes its logits, its masked NLL sum and token
    count, then frees the logits, and is recomputed in the backward pass
    (``checkpoint``), so the backward too never holds more than one
    chunk of [B, chunk, V] f32 logits.
    """
    B, S, D = x.shape
    chunk = min(chunk, S)
    if S % chunk != 0:
        chunk = S  # fallback: single chunk
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    w = w.to(x.dtype)
    if mask is None:
        mask = torch.ones(labels.shape, dtype=f32, device=x.device)
    tot = cnt = None
    for c0 in range(0, S, chunk):
        t, n = remat(_chunk_nll, cfg, x[:, c0:c0 + chunk], w,
                     labels[:, c0:c0 + chunk], mask[:, c0:c0 + chunk])
        # on a mesh t is a partial sum: added to a plain zero, DTensor
        # would reduce it at once in one torch version and defer it in
        # another
        tot, cnt = (t, n) if tot is None else (tot + t, cnt + n)
    return tot / torch.clamp(cnt, min=1.0)


def cfg_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.activation_dtype)


def param_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)
