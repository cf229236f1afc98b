"""Jamba: Mamba + attention 1:7 interleave with every-other-layer MoE.

The port of ``repro/models/jamba.py``: layer i is attention iff i %
attn_period == 0, else Mamba; its FFN is an MoE iff ``cfg.moe`` is set
and i is odd (``_slot_is_moe``), a dense MLP otherwise. Params keep the
JAX names and their stacked [n_periods] axis per period slot; the port
loops over periods and slots in Python. The router aux loss is summed
over the MoE slots, as the reference's scan carry sums it.

As in the JAX package, prefill returns no cache: decode starts from a
zero cache of ``cache_struct``. A decode step writes the new k, v and
Mamba states into the cache in place and returns the same dict. A
training forward with ``cfg.remat == "layer"`` recomputes each period in
the backward pass (``torch.utils.checkpoint``, the JAX
``jax.checkpoint(period_body)``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba
from repro_torch.models.moe import moe_ffn, moe_table
from repro_torch.sharding import tag

f32 = torch.float32


def _slot_is_attn(cfg, s: int) -> bool:
    return s % cfg.attn_period == 0


def _slot_is_moe(cfg, s: int) -> bool:
    # global layer index = period * attn_period + s; parity == parity of s
    return cfg.moe is not None and s % 2 == 1


def n_periods(cfg) -> int:
    if cfg.n_layers % cfg.attn_period:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"attn_period {cfg.attn_period}")
    return cfg.n_layers // cfg.attn_period


def jamba_table(cfg) -> L.ParamTable:
    np_ = n_periods(cfg)
    t: L.ParamTable = {}
    t.update(L.embed_table(cfg))
    t.update(L.norm_table(cfg, "ln_final"))
    for s in range(cfg.attn_period):
        pre = f"period/s{s}"
        t.update(L.norm_table(cfg, pre + "/ln_mix", np_))
        t.update(L.norm_table(cfg, pre + "/ln_ffn", np_))
        if _slot_is_attn(cfg, s):
            t.update(L.attn_table(cfg, pre + "/attn", np_))
        else:
            t.update(mamba.mamba_table(cfg, pre + "/mamba", np_))
        if _slot_is_moe(cfg, s):
            t.update(moe_table(cfg, pre + "/moe", np_))
        else:
            t.update(L.mlp_table(cfg, pre + "/mlp", np_))
    return t


def _layer(params: Dict, prefix: str, i: int) -> Dict:
    """The i-th layer's params under ``prefix``, prefix stripped."""
    n = len(prefix)
    return {k[n:]: v[i] for k, v in params.items() if k.startswith(prefix)}


def _sub(p: Dict, prefix: str) -> Dict:
    n = len(prefix)
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix)}


def _decode_attention(cfg, ap, hn, kc, vc, pos: int):
    """One token's attention: q, k, v with f32 products cast to the
    activation dtype, RoPE at ``pos``, k and v written into the caches in
    place at ``pos``."""
    dtype = hn.dtype
    q, k, v = (L._f32_proj_heads(hn, ap[w]).to(dtype)
               for w in ("wq", "wk", "wv"))
    pvec = torch.full((1,), pos, dtype=torch.int32, device=hn.device)
    q = L.rope(q, pvec, cfg.rope_theta)
    k = L.rope(k, pvec, cfg.rope_theta)
    L.cache_write(kc, pos, k[:, 0])
    L.cache_write(vc, pos, v[:, 0])
    return L.decode_attention(q[:, 0], kc, vc, pos)[:, None]


def _ffn(cfg, sp, s: int, hn, kind):
    """Slot ``s``'s FFN on the normed ``hn`` -> (y, router aux loss)."""
    if _slot_is_moe(cfg, s):
        return moe_ffn(cfg, _sub(sp, "moe/"), hn, kind)
    return L.mlp(cfg, _sub(sp, "mlp/"), hn), torch.zeros(
        (), dtype=f32, device=hn.device)


def _period(cfg, params, p: int, x, positions, kind):
    """Period ``p`` of a training or prefill forward: each slot's mixer
    (attention or Mamba) and its FFN, pre-normed and added to the
    residual. -> (x, the period's router aux loss)."""
    dtype = x.dtype
    aux = torch.zeros((), dtype=f32, device=x.device)
    for s in range(cfg.attn_period):
        sp = _layer(params, f"period/s{s}/", p)
        hn = L.norm(cfg, sp, "ln_mix", x)
        if _slot_is_attn(cfg, s):
            ap = _sub(sp, "attn/")
            q, k, v = L.qkv_proj(cfg, ap, hn, positions)
            mix = L.out_proj(ap, L.blockwise_causal_attention(q, k, v))
        else:
            mix, _ = mamba.mamba_mix(cfg, _sub(sp, "mamba/"), hn)
        x = x + mix.to(dtype)
        y, a = _ffn(cfg, sp, s, L.norm(cfg, sp, "ln_ffn", x), kind)
        x = tag(x + y.to(dtype), "batch", "seq", None)
        aux = aux + a
    return x, aux


def forward(cfg, params, tokens, kind: str, cache=None, pos=None):
    """kind='train' or 'prefill': tokens [B, T]; 'decode': tokens [B] at
    ``pos``.

    cache (decode): {'k','v': [np,B,S,KVH,hd], 'conv': [np,7,B,dc-1,di],
    'h': [np,7,B,di,ds]}, updated in place. Returns (hidden, router aux
    loss, cache), the cache None after train and prefill, as the
    reference's.
    """
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"kind {kind!r}: 'train', 'prefill' or 'decode'")
    dtype = L.cfg_dtype(cfg)
    decode = kind == "decode"
    x = L.embed(cfg, params, tokens[:, None] if decode else tokens)
    positions = (None if decode
                 else torch.arange(x.shape[1], device=x.device))
    aux = torch.zeros((), dtype=f32, device=x.device)
    if not decode:
        remat = kind == "train" and cfg.remat == "layer"
        for p in range(n_periods(cfg)):
            if remat:
                x, a = L.remat(_period, cfg, params, p, x, positions, kind)
            else:
                x, a = _period(cfg, params, p, x, positions, kind)
            aux = aux + a
        return L.norm(cfg, params, "ln_final", x), aux, None
    for p in range(n_periods(cfg)):
        mi = 0
        for s in range(cfg.attn_period):
            sp = _layer(params, f"period/s{s}/", p)
            hn = L.norm(cfg, sp, "ln_mix", x)
            if _slot_is_attn(cfg, s):
                ap = _sub(sp, "attn/")
                mix = L.out_proj(ap, _decode_attention(
                    cfg, ap, hn, cache["k"][p], cache["v"][p], pos))
            else:
                state = (cache["conv"][p, mi], cache["h"][p, mi])
                mix, (conv2, h2) = mamba.mamba_mix(cfg, _sub(sp, "mamba/"),
                                                   hn, state)
                cache["conv"][p, mi] = conv2.to(cache["conv"].dtype)
                cache["h"][p, mi] = h2.to(cache["h"].dtype)
                mi += 1
            x = x + mix.to(dtype)
            y, a = _ffn(cfg, sp, s, L.norm(cfg, sp, "ln_ffn", x), kind)
            x = x + y.to(dtype)
            aux = aux + a
    return L.norm(cfg, params, "ln_final", x), aux, cache


def cache_struct(cfg, batch: int, seq: int, dtype):
    """{'k', 'v', 'conv', 'h'}: (shape, dtype) of the decode cache."""
    np_ = n_periods(cfg)
    KVH, hd = cfg.n_kv_heads, cfg.resolved_head_dim()
    di, dtr, ds, dc = mamba.dims(cfg)
    nm = cfg.attn_period - 1
    return {"k": ((np_, batch, seq, KVH, hd), dtype),
            "v": ((np_, batch, seq, KVH, hd), dtype),
            "conv": ((np_, nm, batch, dc - 1, di), dtype),
            "h": ((np_, nm, batch, di, ds), dtype)}


def cache_axes(cfg):
    """The logical axes of ``cache_struct``'s entries (the reference's)."""
    return {"k": ("layers", "cache_batch", "cache_seq", "kv_heads", None),
            "v": ("layers", "cache_batch", "cache_seq", "kv_heads", None),
            "conv": ("layers", None, "cache_batch", None, "ffn"),
            "h": ("layers", None, "cache_batch", "ffn", None)}
