"""RWKV-6 (Finch): attention-free token mixing with data-dependent decay.

The port of ``repro/models/rwkv.py`` (arXiv:2404.05892): ddlerp token
shift (5-way LoRA), low-rank data-dependent decay w_t = exp(-exp(.)),
per-head bonus u, group-norm + SiLU output gate, squared-ReLU channel
mix.

A sequence is processed in chunks of ``WKV_CHUNK`` steps: within a chunk
the WKV recurrence is evaluated in closed matmul form with per-channel
decay factors (``_wkv_chunk``); the state crosses chunks in a Python
loop. The reference has no Pallas kernel here (its WKV is jnp), so
neither has the port: the chunk products are batched over every chunk of
the sequence at once, and only the state carry, a multiply and an add a
chunk, runs in the loop. Decode is a single recurrence step.

Two reference behaviours are mirrored, not fixed (ROADMAP.md Queue 3):
a T that is not a multiple of ``WKV_CHUNK`` is processed as one chunk of
T steps, where ``exp(-cw)`` overflows f32 beyond about 17 steps at
``LOGW_MIN``; and the prefill cache keeps the ``wkv`` state in the
config's activation dtype (bf16 when serving in bf16).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.sharding import is_dtensor, tag

f32 = torch.float32

# exponent-safety clamp for per-step log-decay (see module docstring)
LOGW_MIN = -5.0
LOGW_MAX = -1e-4
WKV_CHUNK = 16


def rwkv_table(cfg) -> L.ParamTable:
    d, nl = cfg.d_model, cfg.n_layers
    H = cfg.n_heads
    K = cfg.rwkv.head_dim
    dl, tl = cfg.rwkv.decay_lora, cfg.rwkv.tokenshift_lora
    ff = cfg.d_ff
    s = 0.02
    Vp = L.padded_vocab(cfg.vocab_size)
    t: L.ParamTable = {"embed": ((Vp, d), ("vocab", "dmodel"), ("normal", s)),
                       "unembed": ((d, Vp), ("fsdp", "vocab"), ("normal", s))}
    for pre in ("ln0", "ln_final"):
        t[pre + "/scale"] = ((d,), ("dmodel",), ("zeros",))
        t[pre + "/bias"] = ((d,), ("dmodel",), ("zeros",))

    def lt(name, shape, axes, init=("normal", s)):
        t["layer/" + name] = ((nl,) + shape, ("layers",) + axes, init)
    for pre in ("ln1", "ln2"):
        lt(pre + "/scale", (d,), ("dmodel",), ("zeros",))
        lt(pre + "/bias", (d,), ("dmodel",), ("zeros",))
    # time-mix
    lt("mu_x", (d,), ("dmodel",), ("const", 0.5))
    lt("mu", (5, d), (None, "dmodel"), ("const", 0.5))
    lt("ts_w1", (d, 5 * tl), ("dmodel", None))
    lt("ts_w2", (5, tl, d), (None, None, "dmodel"), ("zeros",))
    lt("w_r", (d, H * K), ("fsdp", "heads"))
    lt("w_k", (d, H * K), ("fsdp", "heads"))
    lt("w_v", (d, H * K), ("fsdp", "heads"))
    lt("w_g", (d, H * K), ("fsdp", "heads"))
    lt("w_o", (H * K, d), ("heads", "fsdp"))
    lt("w0", (H * K,), ("heads",), ("const", -1.0))
    lt("dw1", (d, dl), ("dmodel", None))
    lt("dw2", (dl, H * K), (None, "heads"), ("zeros",))
    lt("u", (H, K), ("heads", None), ("normal", s))
    lt("gn/scale", (H * K,), ("heads",), ("zeros",))
    lt("gn/bias", (H * K,), ("heads",), ("zeros",))
    # channel-mix
    lt("mu_k", (d,), ("dmodel",), ("const", 0.5))
    lt("mu_r", (d,), ("dmodel",), ("const", 0.5))
    lt("wk_c", (d, ff), ("fsdp", "ffn"))
    lt("wv_c", (ff, d), ("ffn", "fsdp"))
    lt("wr_c", (d, d), ("fsdp", "dmodel"))
    return t


def _shift(x, x_prev):
    """x: [B,T,d]; x_prev: [B,d] carry (last token of previous segment)."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _dot(x, w):
    """x @ w with w in x's dtype and the sum in f32 (the reference's
    ``preferred_element_type=f32``)."""
    return L._f32_dot(x, w.to(x.dtype))


def _ddlerp(p, x, dx):
    """RWKV6 data-dependent token-shift; returns the 5 mixed streams."""
    xxx = x + dx * p["mu_x"].to(x.dtype)
    B, T, d = x.shape
    k5 = torch.tanh(_dot(xxx, p["ts_w1"]))
    tl = p["ts_w1"].shape[1] // 5
    k5 = k5.reshape(B, T, 5, tl)
    deltas = torch.einsum("btfl,fld->btfd", k5, p["ts_w2"].to(f32))
    mus = p["mu"].to(f32) + deltas  # [B,T,5,d]
    return [(x + dx * m.to(x.dtype)) for m in mus.unbind(2)]


def _wkv_chunks(r, k, v, logw, u, state, c: int):
    """The WKV recurrence over T = n c steps in chunks of ``c``, each in
    closed form (``_wkv_chunk``'s arithmetic, batched over the n chunks),
    the state carried from chunk to chunk.

    r,k: [B,T,H,K]; v: [B,T,H,V]; logw: [B,T,H,K] (<=0); u: [H,K];
    state: [B,H,K,V] f32. Returns (out [B,T,H,V] f32, new_state).
    """
    B, T, H, K = r.shape
    n = T // c

    def cut(a):
        return a.to(f32).reshape(B, n, c, H, a.shape[-1])
    r, k, v, logw = cut(r), cut(k), cut(v), cut(logw)
    cw = torch.cumsum(logw, dim=2)           # inclusive
    cwx = cw - logw                          # exclusive (decay up to t-1)
    r_in = r * torch.exp(cwx)
    # intra-chunk: att[t,s] = sum_k r_t k_s exp(cwx_t - cw_s), s < t
    k_dec = k * torch.exp(-cw)
    att = torch.einsum("bnthk,bnshk->bnhts", r_in, k_dec)
    mask = torch.tril(torch.ones(c, c, dtype=torch.bool, device=r.device),
                      diagonal=-1)
    att = torch.where(mask, att, 0.0)
    intra = torch.einsum("bnhts,bnshv->bnthv", att, v)
    # diagonal bonus
    coeff = torch.einsum("bnthk,hk,bnthk->bnth", r, u.to(f32), k)
    diag = coeff[..., None] * v
    # each chunk's state update: S' = exp(cw_last) S + sum_s k_s
    # exp(cw_last - cw_s) v_s
    cw_last = cw[:, :, -1]                   # [B,n,H,K]
    k_tail = k * torch.exp(cw_last[:, :, None] - cw)
    kv = torch.einsum("bnshk,bnshv->bnhkv", k_tail, v)
    decay = torch.exp(cw_last)[..., None]
    # only the carry runs in the loop, over tensors unbound once (a
    # chunk's slice taken in the loop would cost its backward a zero-filled
    # gradient of the whole tensor, n times); each chunk's read of the
    # state entering it is one product over all chunks after
    states = []
    for d_j, kv_j in zip(decay.unbind(1), kv.unbind(1)):
        states.append(state)
        state = d_j * state + kv_j
    inter = torch.einsum("bnthk,bnhkv->bnthv", r_in, torch.stack(states, 1))
    out = inter + intra + diag
    return out.reshape(B, T, H, v.shape[-1]), state


def _wkv(r, k, v, logw, u, state, c: int):
    """``_wkv_chunks``; on DTensors each rank's heads and rows under
    ``local_map`` (the recurrence is per head, the reference's 'heads'
    over the model axis): u's gradient a partial sum over the batch split,
    the state split as r's rows and heads."""
    if not is_dtensor(r):
        return _wkv_chunks(r, k, v, logw, u, state, c)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    dm = r.device_mesh
    R = Replicate()
    tp = tuple(p if p in (Shard(0), Shard(2)) else R for p in r.placements)
    up = tuple(Shard(0) if p == Shard(2) else R for p in tp)
    ug = tuple(Partial() if p == Shard(0) else q for p, q in zip(tp, up))
    sp = tuple(Shard(1) if p == Shard(2) else p for p in tp)
    if not is_dtensor(state):
        state = DTensor.from_local(state, dm, [R] * dm.ndim)
    return local_map(
        lambda *a: _wkv_chunks(*a, c), out_placements=(tp, sp),
        in_placements=(tp, tp, tp, tp, up, sp),
        in_grad_placements=(tp, tp, tp, tp, ug, sp), device_mesh=dm,
        redistribute_inputs=True)(r, k, v, logw, u, state)


def _wkv_chunk(r, k, v, logw, u, state):
    """One chunk of the WKV recurrence in closed form (the reference's
    ``_wkv_chunk``): ``_wkv_chunks`` with the chunk the whole of T."""
    return _wkv_chunks(r, k, v, logw, u, state, r.shape[1])


def _decay_log(p, xw):
    """log w [.., H*K] f32 from the decay stream: w0 + tanh(xw) dw1 dw2,
    then -exp(.) clamped to [LOGW_MIN, LOGW_MAX]."""
    dlog = p["w0"].to(f32) + L.mm(L.mm(torch.tanh(xw.to(f32)),
                                       p["dw1"].to(f32)), p["dw2"].to(f32))
    return torch.clamp(-torch.exp(dlog), LOGW_MIN, LOGW_MAX)


def time_mix(cfg, p, x, tm_x, wkv_state):
    """x: [B,T,d]. Returns (out [B,T,d], last_x [B,d], new_state)."""
    B, T, d = x.shape
    H, K = cfg.n_heads, cfg.rwkv.head_dim
    dx = _shift(x, tm_x) - x
    xw, xk, xv, xr, xg = _ddlerp(p, x, dx)
    r = _dot(xr, p["w_r"]).reshape(B, T, H, K)
    k = _dot(xk, p["w_k"]).reshape(B, T, H, K)
    v = _dot(xv, p["w_v"]).reshape(B, T, H, K)
    g = _dot(xg, p["w_g"])
    logw = _decay_log(p, xw).reshape(B, T, H, K)
    c = min(WKV_CHUNK, T)
    if T % c != 0:
        c = T
    out, new_state = _wkv(r, k, v, logw, p["u"], wkv_state.to(f32), c)
    out = _gn_gate(cfg, p, out, g, B, T)
    y = _dot(out, p["w_o"]).to(x.dtype)
    return y, x[:, -1], new_state


def _gn_gate(cfg, p, out, g, B, T):
    """Per-head group norm of the WKV output, then the SiLU gate; f32."""
    H, K = cfg.n_heads, cfg.rwkv.head_dim
    mu = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, correction=0)
    out = (out - mu) * torch.rsqrt(var + 1e-5)
    out = out.reshape(B, T, H * K)
    out = out * (1.0 + p["gn/scale"].to(f32)) + p["gn/bias"].to(f32)
    return (out * F.silu(g)).to(f32)


def _wkv_step_local(r, k, v, w, u, S):
    """One WKV step: r, k, v, w [B,H,K]; u [H,K]; S [B,H,K,V] f32 ->
    (out [B,H,V], new state)."""
    kv = k[..., None] * v[..., None, :]  # [B,H,K,V]
    out = torch.einsum("bhk,bhkv->bhv", r,
                       S + u.to(f32)[None, :, :, None] * kv)
    return out, w[..., None] * S + kv


def _wkv_step(r, k, v, w, u, S):
    """``_wkv_step_local``; on DTensors each rank's rows and heads under
    ``local_map`` (DTensor's own rule for the einsum flattens a split
    batch into the heads)."""
    if not is_dtensor(r):
        return _wkv_step_local(r, k, v, w, u, S)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    dm = r.device_mesh
    R = Replicate()
    tp = tuple(p if p in (Shard(0), Shard(1)) else R for p in r.placements)
    up = tuple(Shard(0) if p == Shard(1) else R for p in tp)
    if not is_dtensor(S):
        S = DTensor.from_local(S, dm, [R] * dm.ndim)
    return local_map(_wkv_step_local, out_placements=(tp, tp),
                     in_placements=(tp, tp, tp, tp, up, tp), device_mesh=dm,
                     redistribute_inputs=True)(r, k, v, w, u, S)


def time_mix_decode(cfg, p, x, tm_x, wkv_state):
    """Single-token recurrence. x: [B,d]. Returns (out, x, new_state)."""
    B, d = x.shape
    H, K = cfg.n_heads, cfg.rwkv.head_dim
    xt = x[:, None]
    dx = (tm_x - x)[:, None]
    xw, xk, xv, xr, xg = _ddlerp(p, xt, dx)
    r = _dot(xr, p["w_r"])[:, 0].reshape(B, H, K)
    k = _dot(xk, p["w_k"])[:, 0].reshape(B, H, K)
    v = _dot(xv, p["w_v"])[:, 0].reshape(B, H, K)
    g = _dot(xg, p["w_g"])[:, 0]
    w = torch.exp(_decay_log(p, xw[:, 0])).reshape(B, H, K)
    out, new_state = _wkv_step(r, k, v, w, p["u"], wkv_state.to(f32))
    out = _gn_gate(cfg, p, out[:, None], g[:, None], B, 1)
    y = _dot(out, p["w_o"])[:, 0]
    return y.to(x.dtype), x, new_state


def channel_mix(cfg, p, x, cm_x):
    dx = _shift(x, cm_x) - x
    xk = x + dx * p["mu_k"].to(x.dtype)
    xr = x + dx * p["mu_r"].to(x.dtype)
    k = torch.square(torch.relu(_dot(xk, p["wk_c"])))
    kv = _dot(k.to(x.dtype), p["wv_c"])
    r = torch.sigmoid(_dot(xr, p["wr_c"]))
    return (r * kv).to(x.dtype), x[:, -1]


def _layer(cfg, lp, h):
    """One layer of a train or prefill forward from a zero state: ->
    (h, tm_x, wkv f32, cm_x)."""
    B, d = h.shape[0], cfg.d_model
    H, K = cfg.n_heads, cfg.rwkv.head_dim
    hn = L.layernorm(h, lp["ln1/scale"], lp["ln1/bias"])
    out, tm_x, wkv = time_mix(cfg, lp, hn,
                              torch.zeros(B, d, dtype=h.dtype,
                                          device=h.device),
                              torch.zeros(B, H, K, K, dtype=f32,
                                          device=h.device))
    h = h + out
    hn = L.layernorm(h, lp["ln2/scale"], lp["ln2/bias"])
    out, cm_x = channel_mix(cfg, lp, hn,
                            torch.zeros(B, d, dtype=h.dtype, device=h.device))
    return tag(h + out, "batch", "seq", None), tm_x, wkv, cm_x


def forward(cfg, params, tokens, kind: str, cache=None):
    """kind='train'/'prefill': tokens [B,T] -> (hidden [B,T,d], cache
    {'tm_x', 'wkv', 'cm_x'} stacked over layers, or None for train).
    kind='decode': tokens [B], one recurrence step from ``cache``, which
    is updated in place -> (hidden [B,1,d], cache). (The JAX forward also
    returns the MoE router loss, 0 here.)"""
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"kind {kind!r}: 'train', 'prefill' or 'decode'")
    layer_p = {k[len("layer/"):]: v for k, v in params.items()
               if k.startswith("layer/")}
    other = {k: v for k, v in params.items() if not k.startswith("layer/")}
    x = L.embed(cfg, params, tokens)
    x = L.layernorm(x, other["ln0/scale"], other["ln0/bias"])
    if kind != "decode":
        x = tag(x, "batch", "seq", None)
    ln_f = (other["ln_final/scale"], other["ln_final/bias"])

    if kind == "decode":
        for i in range(cfg.n_layers):
            lp = {k: v[i] for k, v in layer_p.items()}
            hn = L.layernorm(x, lp["ln1/scale"], lp["ln1/bias"])
            out, tm_x, wkv = time_mix_decode(cfg, lp, hn, cache["tm_x"][i],
                                             cache["wkv"][i])
            x = x + out
            hn = L.layernorm(x, lp["ln2/scale"], lp["ln2/bias"])
            out, cm_x = channel_mix(cfg, lp, hn[:, None], cache["cm_x"][i])
            # the residual's partial sums settled at the layer's end (on a
            # mesh), as the train path's tag does
            x = tag(x + out[:, 0], "batch", None)
            cache["tm_x"][i] = tm_x
            cache["wkv"][i] = wkv.to(cache["wkv"].dtype)
            cache["cm_x"][i] = cm_x
        return L.layernorm(x, *ln_f)[:, None], cache

    dtype = x.dtype
    states = {"tm_x": [], "wkv": [], "cm_x": []}
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layer_p.items()}
        if kind == "train" and cfg.remat == "layer":
            x, tm_x, wkv, cm_x = L.remat(_layer, cfg, lp, x)
        else:
            x, tm_x, wkv, cm_x = _layer(cfg, lp, x)
        if kind == "prefill":
            states["tm_x"].append(tm_x)
            states["wkv"].append(wkv.to(dtype))
            states["cm_x"].append(cm_x)
    x = L.layernorm(x, *ln_f)
    cache = ({k: torch.stack(v) for k, v in states.items()}
             if kind == "prefill" else None)
    return x, cache


def cache_struct(cfg, batch: int, dtype):
    """{'tm_x', 'wkv', 'cm_x'}: (shape, dtype) of the recurrent cache."""
    H, K, d, nl = cfg.n_heads, cfg.rwkv.head_dim, cfg.d_model, cfg.n_layers
    return {"tm_x": ((nl, batch, d), dtype),
            "wkv": ((nl, batch, H, K, K), dtype),
            "cm_x": ((nl, batch, d), dtype)}


def cache_axes(cfg):
    """The logical axes of ``cache_struct``'s entries (the reference's)."""
    return {"tm_x": ("layers", "cache_batch", None),
            "wkv": ("layers", "cache_batch", "heads", None, None),
            "cm_x": ("layers", "cache_batch", None)}
