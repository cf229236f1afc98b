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

Not ported yet: ``ring_attention``/``use_ring_attention`` and
``_attn_block_size`` (mesh; ROADMAP.md Queue 1 item 14g).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops

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
               device) -> Dict[str, torch.Tensor]:
    """Draw every param of ``table`` in sorted-name order from one
    generator, on ``device`` (the generator's device), in f32 cast to
    ``dtype``. Same distributions as the JAX ``table_init``; not the same
    numbers. A table over ``DRAW_SLICE`` elements is drawn slice by slice
    along its leading axes, so that its f32 draw costs one slice beside
    the result (Moonlight's stacked expert tables are 35 GB each in f32);
    one under it is one draw."""
    out = {}
    for name, (shape, _, init) in sorted(table.items()):
        out[name] = torch.empty(shape, dtype=dtype, device=device)
        _draw(out[name], init, generator)
    return out


def _f32_dot(x, w):
    """x [..., K] @ w [K, N] with f32 output, as JAX's
    ``preferred_element_type=f32``."""
    return x.to(f32) @ w.to(f32)


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


def blockwise_causal_attention(q, k, v):
    """Causal GQA attention, q: [B, S, H, hd]; k, v: [B, S, KVH, hd].

    On the card this is the hand-written flash-attention kernel, on the
    CPU its plain version (``ops.flash_attention``). Both keep p to f32
    precision before P.V (the bf16 kernel as a bf16 hi and lo pair, to
    about 2^-16); the JAX blockwise path casts p to q's dtype first, so
    at bf16 the port follows the TPU kernel, and at f32 the two agree to
    rounding.
    """
    return ops.flash_attention(q, k, v)


def full_attention(q, k, v, causal: bool):
    """Plain GQA attention over a short kv (the whisper encoder and the
    cross-attention), causal or not. q: [B, Sq, H, hd]; k, v: [B, Sk,
    KVH, hd] -> [B, Sq, H, hd] in q's dtype.

    The JAX package computes it with ``einsum`` outside any Pallas
    kernel, so here it stays matmul and softmax on the card too. Scores
    in f32; p is cast to q's dtype before P.V (the reference's rounding,
    not the flash kernel's hi/lo pair), summed in f32.
    """
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


def decode_attention(q, k_cache, v_cache, pos: int):
    """Single-token attention against a fixed-size cache.

    q: [B, H, hd]; caches: [B, S, KVH, hd]; pos: tokens < pos+1 are valid
    (the current token was already written at ``pos``).
    """
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
    d, H, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, H * hd)).reshape(
        x.shape[:-1] + (H, hd))


def _f32_proj_heads(x, w):
    """x [B, S, d] @ w [d, H, hd] -> [B, S, H, hd] f32, as JAX's
    ``preferred_element_type=f32`` einsum."""
    d, H, hd = w.shape
    return _f32_dot(x, w.reshape(d, H * hd)).reshape(x.shape[:-1] + (H, hd))


def qkv_proj(cfg, p, x, positions=None):
    """x: [B, S, D] -> q [B,S,H,hd], k,v [B,S,KVH,hd] (+RoPE if positions)."""
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x, p["wk"])
    v = _proj_heads(x, p["wv"])
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(p, o):
    """o [B, S, H, hd] @ wo [H, hd, d] -> [B, S, d] in o's dtype."""
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
    up = x @ p["w_up"].to(x.dtype)
    if cfg.mlp_variant == "swiglu":
        g = x @ p["w_gate"].to(x.dtype)
        h = F.silu(g.to(f32)).to(x.dtype) * up
    elif cfg.mlp_variant == "geglu":
        g = x @ p["w_gate"].to(x.dtype)
        h = F.gelu(g.to(f32), approximate="tanh").to(x.dtype) * up
    elif cfg.mlp_variant == "relu2":
        h = torch.square(torch.relu(up))
    elif cfg.mlp_variant == "gelu":
        h = F.gelu(up.to(f32), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(f"unknown mlp_variant {cfg.mlp_variant!r}")
    return h.to(x.dtype) @ p["w_down"].to(x.dtype)


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


def embed(cfg, params, tokens):
    return params["embed"][tokens].to(cfg_dtype(cfg))


def logits_fn(cfg, params, x):
    """f32 logits over the REAL vocab (padded columns sliced off)."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = _f32_dot(x, w.to(x.dtype))
    return logits[..., :cfg.vocab_size]


def _label_select(shifted, labels):
    """Each row's ``shifted`` logit at its label, in the JAX comparison
    form (iota == label, then a sum over the vocab): no gather, whose
    backward would be a float scatter-add."""
    V = shifted.shape[-1]
    iota = torch.arange(V, device=shifted.device, dtype=labels.dtype)
    return torch.where(iota == labels[..., None], shifted, 0.0).sum(-1)


def softmax_xent(logits, labels, mask=None):
    """Sharded-vocab-safe cross-entropy: no gather over the vocab dim.

    logits: [B, S, V] f32; labels: [B, S] int; mask: [B, S] (1 = count).
    """
    lmax = logits.amax(-1, keepdim=True).detach()
    shifted = logits - lmax
    lse = torch.log(torch.exp(shifted).sum(-1)) + lmax[..., 0]
    nll = lse - (_label_select(shifted, labels) + lmax[..., 0])
    if mask is None:
        return nll.mean()
    mask = mask.to(f32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _chunk_nll(cfg, xc, w, lc, mc):
    """One sequence chunk of ``chunked_lm_loss``: its logits (padded vocab
    columns at -1e30), then (masked NLL sum, token count)."""
    logits = _f32_dot(xc, w)
    V = logits.shape[-1]
    if V != cfg.vocab_size:                   # mask padded vocab columns
        pad = torch.arange(V, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad, _NEG, logits)
    lmax = logits.amax(-1, keepdim=True).detach()
    shifted = logits - lmax
    lse = torch.log(torch.exp(shifted).sum(-1)) + lmax[..., 0]
    nll = lse - (_label_select(shifted, lc) + lmax[..., 0])
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
    tot = torch.zeros((), dtype=f32, device=x.device)
    cnt = torch.zeros((), dtype=f32, device=x.device)
    for c0 in range(0, S, chunk):
        t, n = checkpoint(_chunk_nll, cfg, x[:, c0:c0 + chunk], w,
                          labels[:, c0:c0 + chunk], mask[:, c0:c0 + chunk],
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def cfg_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.activation_dtype)


def param_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)
