"""Decoder-only transformer with a KV cache, optional cross-attention (the
whisper decoder) and an optional learned positional table.

The port of ``repro/models/transformer.py``: training, prefill and
decode, each layer's FFN a dense MLP, an MoE (``cfg.moe`` with layout
"all") or an MoE beside a dense residual MLP on the same normed input
(Arctic). Per-layer params keep the JAX names under
``"layer/"`` and their stacked leading [L] axis; the port loops over
layers in Python. With ``cfg.remat == "layer"`` a training forward
recomputes each layer in the backward pass (``torch.utils.checkpoint``,
the JAX ``jax.checkpoint`` of the layer body). A decode step writes the
new k and v into the cache in place and returns it; the cross-attention's
k and v (``xk``, ``xv``) are projected from the encoder output at prefill
and read from the cache at decode. The MoE router's aux loss is summed
over layers, as the reference's scan carry sums it.

On a mesh (active ``sharding`` rules) the reference's tags hold: the
residual stream is sequence-parallel between layers (``seq_sp``), the
matmul inputs are gathered over the sequence (``seq``), and an arch whose
heads do not divide the model axis takes ``layers.ring_attention`` on the
seq-sharded residual.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.moe import moe_ffn, moe_table
from repro_torch.sharding import tag

f32 = torch.float32


def is_moe_layer(cfg) -> bool:
    return cfg.moe is not None and cfg.moe.layout == "all"


def decoder_table(cfg, max_seq: int = 0, cross: bool = False
                  ) -> L.ParamTable:
    """``cross`` adds the cross-attention and its norm to every layer;
    ``max_seq`` > 0 a learned positional table [max_seq, d] (whisper)."""
    nl = cfg.n_layers
    t: L.ParamTable = {}
    t.update(L.embed_table(cfg))
    t.update(L.attn_table(cfg, "layer/attn", nl))
    t.update(L.norm_table(cfg, "layer/ln_attn", nl))
    t.update(L.norm_table(cfg, "ln_final"))
    if cross:
        t.update(L.attn_table(cfg, "layer/xattn", nl))
        t.update(L.norm_table(cfg, "layer/ln_xattn", nl))
    if is_moe_layer(cfg):
        t.update(moe_table(cfg, "layer/moe", nl))
        if cfg.moe.dense_residual_d_ff:
            t.update(L.mlp_table(cfg, "layer/mlp", nl,
                                 d_ff=cfg.moe.dense_residual_d_ff))
    else:
        t.update(L.mlp_table(cfg, "layer/mlp", nl))
    t.update(L.norm_table(cfg, "layer/ln_mlp", nl))
    if max_seq:
        t["pos_embed"] = ((max_seq, cfg.d_model), (None, "dmodel"),
                          ("normal", 0.02))
    return t


def split_params(params) -> Tuple[Dict, Dict]:
    layer = {k[len("layer/"):]: v for k, v in params.items()
             if k.startswith("layer/")}
    other = {k: v for k, v in params.items() if not k.startswith("layer/")}
    return layer, other


def _sub(p, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix)}


def _ffn(cfg, lp, x, kind, sp=False):
    """The FFN branch on the normed ``x``: a dense MLP, an MoE, or an MoE
    plus the dense residual MLP (Arctic). -> (y, router aux loss)."""
    if not is_moe_layer(cfg):
        return (L.mlp(cfg, _sub(lp, "mlp/"), tag(x, "batch", "seq", None)),
                torch.zeros((), dtype=f32, device=x.device))
    y, aux = moe_ffn(cfg, _sub(lp, "moe/"), x, kind, sp=sp)
    if cfg.moe.dense_residual_d_ff:
        r = L.mlp(cfg, _sub(lp, "mlp/"), tag(x, "batch", "seq", None))
        y = y + (_sp(r) if sp and kind != "decode" else r)
    return y, aux


def _use_rope(cfg) -> bool:
    return cfg.family != "audio"


def _cross_kv(lp, enc_out):
    """The cross-attention's k and v [B, F, KVH, hd] from the encoder
    output [B, F, d]."""
    ap = _sub(lp, "xattn/")
    return L._proj_heads(enc_out, ap["wk"]), L._proj_heads(enc_out, ap["wv"])


def _cross(cfg, lp, x, xk, xv, decode=False):
    """The cross-attention branch of a layer, pre-normed: queries from
    ``x``, non-causal over the encoder's frames."""
    ap = _sub(lp, "xattn/")
    hn = L.norm(cfg, lp, "ln_xattn", x)
    if not decode:
        hn = tag(hn, "batch", "seq", None)
    q = L._proj_heads(hn, ap["wq"])
    return L.out_proj(ap, L.full_attention(q, xk, xv, causal=False))


def _self_attn(cfg, lp, x, positions):
    """A train or prefill layer's self-attention on the pre-normed
    residual: (out, k, v). On a mesh whose model axis the heads do not
    divide, the ring on the seq-sharded residual; else the heads-sharded
    flash attention on the residual gathered over the sequence."""
    ap = _sub(lp, "attn/")
    hn = L.norm(cfg, lp, "ln_attn", x)
    ring = L.use_ring_attention(cfg, x.shape[0], x.shape[1])
    if not ring:
        hn = tag(hn, "batch", "seq", None)
    q, k, v = L.qkv_proj(cfg, ap, hn, positions, sp=ring)
    o = (L.ring_attention(q, k, v) if ring
         else L.blockwise_causal_attention(q, k, v))
    return L.out_proj(ap, o), k, v


def _sp(y):
    """A branch's output put on the sequence-parallel residual's split
    before the add (the reference's reduce-scatter into ``seq_sp``): the
    gradient then comes back gathered over the sequence, as the branch's
    products take it."""
    return tag(y, "batch", "seq_sp", None)


def _train_layer(cfg, lp, x, positions, enc_out):
    """One layer of the training forward: attention, the cross-attention
    where there is an encoder output, then the FFN, each pre-normed and
    added to the residual. -> (x, the layer's router aux loss)."""
    out, _, _ = _self_attn(cfg, lp, x, positions)
    x = x + _sp(out).to(x.dtype)
    if enc_out is not None:
        x = x + _sp(_cross(cfg, lp, x, *_cross_kv(lp, enc_out))).to(x.dtype)
    y, aux = _ffn(cfg, lp, L.norm(cfg, lp, "ln_mlp", x), "train", sp=True)
    return tag(x + _sp(y).to(x.dtype), "batch", "seq_sp", None), aux


def forward(cfg, params, x, kind: str, *, enc_out=None, cache=None,
            pos=None):
    """Run the decoder stack -> (hidden, router aux loss, cache), as the
    reference's.

    kind='train': x [B, S, D] embedded inputs; the cache is None, each
        layer recomputed in the backward pass when ``cfg.remat ==
        "layer"``.
    kind='prefill': x [B, S, D] embedded inputs; cache {'k','v': [L, B,
        S, KVH, hd]}, with a cross-attention also {'xk','xv': [L, B, F,
        KVH, hd]}.
    kind='decode': x [B, 1, D]; ``cache`` as prefill's (k and v [L, B,
        S, KVH, hd]), k and v updated in place at ``pos`` and returned.
    ``enc_out`` [B, F, D]: the encoder output the cross-attention reads at
    train and prefill (a decoder with ``layer/xattn`` params needs it).
    A ``pos_embed`` param adds the learned position; RoPE applies except
    for the audio family. The aux loss (f32) is the MoE layers' summed,
    0 without experts.
    """
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"kind {kind!r}: 'train', 'prefill' or 'decode'")
    layer_p, other_p = split_params(params)
    cross = any(k.startswith("xattn") for k in layer_p)
    decode = kind == "decode"
    if cross and not decode and enc_out is None:
        raise ValueError("a decoder with cross-attention needs enc_out")
    dtype = x.dtype
    if "pos_embed" in other_p:
        pe = (other_p["pos_embed"][pos:pos + 1] if decode
              else other_p["pos_embed"][:x.shape[1]])
        x = x + pe.to(dtype)[None]
    positions = (torch.full((1,), pos, dtype=torch.int32, device=x.device)
                 if decode else torch.arange(x.shape[1], device=x.device))
    if not _use_rope(cfg):
        positions = None
    aux = torch.zeros((), dtype=f32, device=x.device)
    if not decode:
        x = tag(x, "batch", "seq_sp", None)
    if kind == "train":
        for i in range(cfg.n_layers):
            lp = {k: v[i] for k, v in layer_p.items()}
            if cfg.remat == "layer":
                x, a = L.remat(_train_layer, cfg, lp, x, positions,
                               enc_out)
            else:
                x, a = _train_layer(cfg, lp, x, positions, enc_out)
            aux = aux + a
        x = L.norm(cfg, other_p, "ln_final", x)
        return tag(x, "batch", "seq", None), aux, None
    ks, vs, xks, xvs = [], [], [], []
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layer_p.items()}
        if decode:
            ap = _sub(lp, "attn/")
            q, k, v = L.qkv_proj(cfg, ap, L.norm(cfg, lp, "ln_attn", x),
                                 positions)
            kc, vc = cache["k"][i], cache["v"][i]
            L.cache_write(kc, pos, k[:, 0])
            L.cache_write(vc, pos, v[:, 0])
            o = L.decode_attention(q[:, 0], kc, vc, pos)[:, None]
            out = L.out_proj(ap, o)
        else:
            out, k, v = _self_attn(cfg, lp, x, positions)
            ks.append(k)
            vs.append(v)
        x = x + (out if decode else _sp(out)).to(dtype)
        if cross:
            if decode:
                xk, xv = cache["xk"][i], cache["xv"][i]
            else:
                xk, xv = _cross_kv(lp, enc_out)
                xks.append(xk)
                xvs.append(xv)
            xo = _cross(cfg, lp, x, xk, xv, decode)
            x = x + (xo if decode else _sp(xo)).to(dtype)
        y, a = _ffn(cfg, lp, L.norm(cfg, lp, "ln_mlp", x), kind, sp=True)
        x = x + (y if decode else _sp(y)).to(dtype)
        if not decode:
            x = tag(x, "batch", "seq_sp", None)
        aux = aux + a
    x = L.norm(cfg, other_p, "ln_final", x)
    if not decode:
        x = tag(x, "batch", "seq", None)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
        if cross:
            cache["xk"], cache["xv"] = torch.stack(xks), torch.stack(xvs)
    return x, aux, cache


def cache_struct(cfg, batch: int, seq: int, dtype, cross_frames: int = 0):
    """{'k', 'v'} (and with ``cross_frames`` {'xk', 'xv'} [L, B,
    cross_frames, KVH, hd]): (shape, dtype) of the decode cache."""
    KVH, hd, nl = cfg.n_kv_heads, cfg.resolved_head_dim(), cfg.n_layers
    out = {"k": ((nl, batch, seq, KVH, hd), dtype),
           "v": ((nl, batch, seq, KVH, hd), dtype)}
    if cross_frames:
        out["xk"] = out["xv"] = ((nl, batch, cross_frames, KVH, hd), dtype)
    return out


def cache_axes(cfg, cross: bool = False):
    """The logical axes of ``cache_struct``'s entries (the reference's)."""
    axes = ("layers", "cache_batch", "cache_seq", "kv_heads", None)
    out = {"k": axes, "v": axes}
    if cross:
        out["xk"] = out["xv"] = ("layers", "cache_batch", "frames",
                                 "kv_heads", None)
    return out
