"""Model API of the LM side: param tables, init, cache shapes, the
train state, and the train, prefill and decode steps.

The port of ``repro/models/api.py`` for every family of its LM archs:
``dense`` and ``moe`` decoders, the ``hybrid`` (Jamba) stack with or
without experts, the ``audio`` encoder-decoder (whisper), the ``vlm``
(InternVL2) and the ``ssm`` (RWKV-6). On one device an MoE layer
dispatches with ``moe.moe_dense``, on a mesh with ``moe.moe_a2a``. A
step's batch holds what the JAX one does:
``tokens`` (prefill and train), with ``frames`` [B, F, frontend_dim] for
audio and ``patches`` [B, P, frontend_dim] for vlm;
``token`` and ``pos`` for a decode step. Steps are plain functions; there
is no ``jit``. A train step takes its gradients with
``torch.autograd.grad`` over the param leaves; no graph outlives the step.

On a mesh (``sharding.use_rules`` with rules of more than one rank) the
steps take params, state, cache and batch as DTensors distributed by
their logical axes (``params_axes``, ``state_axes``, ``cache_axes``,
``input_axes``; ``distribute`` cuts a rank's shards of global tensors)
and run the same code: DTensor's rules place the collectives GSPMD
places in the reference, the ``tag`` calls redistribute, and plain
tensors made inside (positions, masks) count as replicated. A param that
is not a DTensor there raises. The loss and the grad norm come back as
plain tensors, the same on every rank.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import jamba as J
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R
from repro_torch.models import transformer as T
from repro_torch.models import vlm as V
from repro_torch.models import whisper as W
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import zeros_like
from repro_torch.sharding import active_rules, is_dtensor

f32 = torch.float32

PORTED_FAMILIES = ("dense", "moe", "hybrid", "audio", "vlm", "ssm")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.arch_id}: family {cfg.family!r} is not an LM family of "
            f"the port: {PORTED_FAMILIES}")


def param_table(cfg: ModelConfig, max_seq: int = 0) -> L.ParamTable:
    """``max_seq`` sizes whisper's learned positional table (4096 when
    0, as in the reference); the other families have none."""
    _require_ported(cfg)
    if cfg.family == "audio":
        return W.whisper_table(cfg, max_seq=max_seq or 4096)
    if cfg.family == "vlm":
        return V.vlm_table(cfg)
    if cfg.family == "ssm":
        return R.rwkv_table(cfg)
    if cfg.family == "hybrid":
        return J.jamba_table(cfg)
    return T.decoder_table(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                max_seq: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """Random params of ``cfg`` in its ``param_dtype``, drawn from
    ``generator`` (which must live on ``device``: CUDA unless the caller
    names another). Under active rules of several ranks, this rank's
    shards (every rank draws every param whole, the same numbers, and
    keeps its block)."""
    dev = resolve_device(device)
    rules = active_rules()
    place = None
    if rules is not None and rules.distributed:
        axes = params_axes(cfg, max_seq)

        def place(name, t):
            return rules.distribute(t, axes[name])
    return L.table_init(param_table(cfg, max_seq), generator,
                        L.param_dtype(cfg), dev, place=place)


def n_params(cfg: ModelConfig, max_seq: int = 0) -> int:
    tot = 0
    for shape, _, _ in param_table(cfg, max_seq).values():
        n = 1
        for s in shape:
            n *= s
        tot += n
    return tot


def n_active_params(cfg: ModelConfig, max_seq: int = 0) -> int:
    """Per-token active params (MoE: only top_k of n_experts count)."""
    tot = 0
    for name, (shape, _, _) in param_table(cfg, max_seq).items():
        n = 1
        for s in shape:
            n *= s
        if "/moe/w_" in name and cfg.moe is not None:
            n = n * cfg.moe.top_k // cfg.moe.n_experts
        tot += n
    return tot


def cache_specs(cfg: ModelConfig,
                shape: ShapeConfig) -> Dict[str, Tuple[Tuple, torch.dtype]]:
    """{name: (shape, dtype)} of the decode cache at this shape: the
    recurrent state for ssm (no sequence axis), the KV cache otherwise,
    with the cross-attention's over the encoder's frames for audio."""
    _require_ported(cfg)
    dt = L.cfg_dtype(cfg)
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        return R.cache_struct(cfg, B, dt)
    if cfg.family == "hybrid":
        return J.cache_struct(cfg, B, S, dt)
    cross = cfg.encoder.n_frames if cfg.family == "audio" else 0
    return T.cache_struct(cfg, B, S, dt, cross_frames=cross)


def cache_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """{name: logical axes} of ``cache_specs``' entries: the axes half of
    the reference's ``cache_specs``."""
    _require_ported(cfg)
    if cfg.family == "ssm":
        return R.cache_axes(cfg)
    if cfg.family == "hybrid":
        return J.cache_axes(cfg)
    return T.cache_axes(cfg, cross=cfg.family == "audio")


def zero_cache(cfg: ModelConfig, shape: ShapeConfig, device) -> Dict:
    """A decode cache of zeros at this shape, on ``device``."""
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in cache_specs(cfg, shape).items()}


def params_struct(cfg: ModelConfig, max_seq: int = 0):
    """{name: (shape, dtype)} of the params, nothing allocated."""
    dt = L.param_dtype(cfg)
    return {k: (shape, dt)
            for k, (shape, _, _) in param_table(cfg, max_seq).items()}


def params_axes(cfg: ModelConfig, max_seq: int = 0) -> Dict[str, Tuple]:
    """{name: logical axes} of the params (the tables' own)."""
    return {k: axes
            for k, (_, axes, _) in param_table(cfg, max_seq).items()}


def state_axes(cfg: ModelConfig, max_seq: int = 0) -> Dict:
    """The train state's logical axes: the moments take their param's."""
    pa = params_axes(cfg, max_seq)
    return {"params": pa, "opt": {"m": pa, "v": dict(pa), "count": ()}}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """{name: (shape, dtype)} of the batch of the step ``shape.kind``
    selects, nothing allocated: tokens and labels (train), tokens
    (prefill), with frames (audio) or patches (vlm, whose tokens are the
    positions after its patches); token and pos (decode)."""
    _require_ported(cfg)
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    adt = L.cfg_dtype(cfg)
    enc = cfg.encoder
    if shape.kind == "decode":
        return {"token": ((B,), i32), "pos": ((), i32)}
    n_p = enc.n_frames if cfg.family == "vlm" else 0
    spec = {"tokens": ((B, S - n_p), i32)}
    if shape.kind == "train":
        spec["labels"] = ((B, S - n_p), i32)
    if cfg.family == "audio":
        spec["frames"] = ((B, enc.n_frames, enc.frontend_dim), adt)
    if cfg.family == "vlm":
        spec["patches"] = ((B, n_p, enc.frontend_dim), adt)
    return spec


def input_axes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Tuple]:
    """{name: logical axes} of ``input_specs``: 'batch' on the leading
    dim, the rest unsharded; ``pos`` has none."""
    return {k: ("batch",) + (None,) * (len(s) - 1) if k != "pos" else ()
            for k, (s, _) in input_specs(cfg, shape).items()}


def distribute(tree: Dict, axes: Dict, rules=None) -> Dict:
    """This rank's shards (DTensors) of a {name: tensor} tree of global
    tensors under ``rules`` (the active ones by default), by the tree's
    logical ``axes``; the tree itself where the rules have one rank or
    none. Every rank passes the same values."""
    rules = rules or active_rules()
    if rules is None or not rules.distributed:
        return tree
    return {k: (v if v.dim() == 0 and not axes[k] else
                rules.distribute(v, axes[k])) for k, v in tree.items()}


def _hidden_and_aux(cfg, params, batch, kind: str):
    """(hidden, router aux loss, cache or None) of a train or prefill
    forward over ``batch``."""
    if cfg.family == "audio":
        if kind == "train":
            return W.forward_train(cfg, params, batch["frames"],
                                   batch["tokens"]) + (None,)
        return W.forward_prefill(cfg, params, batch["frames"],
                                 batch["tokens"])
    if cfg.family == "vlm":
        if kind == "train":
            return V.forward_train(cfg, params, batch["patches"],
                                   batch["tokens"]) + (None,)
        return V.forward_prefill(cfg, params, batch["patches"],
                                 batch["tokens"])
    if cfg.family == "ssm":
        h, cache = R.forward(cfg, params, batch["tokens"], kind)
        return h, torch.zeros((), dtype=f32, device=h.device), cache
    if cfg.family == "hybrid":
        return J.forward(cfg, params, batch["tokens"], kind)
    x = L.embed(cfg, params, batch["tokens"])
    return T.forward(cfg, params, x, kind)


def on_mesh(params):
    """The context a step runs in: with rules of more than one rank,
    DTensor's implicit replication of plain tensors (after checking that
    every param is distributed); else nothing."""
    import contextlib
    rules = active_rules()
    if rules is None or not rules.distributed:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    bad = sorted(k for k, v in params.items() if not is_dtensor(v))
    if bad:
        raise ValueError(f"sharding rules are active but params {bad[:4]} "
                         f"({len(bad)} in all) are not distributed: pass "
                         "api.distribute(params, params_axes(cfg))")
    return implicit_replication()


def _plain(t):
    """A DTensor's value as a plain tensor (a reduce where it is partial);
    a plain tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(params, batch) -> (cache or None, logits of the last
    position [B, V] f32). Jamba's prefill returns no cache."""
    _require_ported(cfg)

    def prefill_step(params, batch):
        with on_mesh(params):
            h, _, cache = _hidden_and_aux(cfg, params, batch, "prefill")
            logits = L.logits_fn(cfg, params, h[:, -1:])
        return cache, logits[:, 0]
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """decode_step(params, cache, {'token': [B], 'pos': int}) -> (cache,
    logits [B, V] f32). The cache is updated in place and returned; an
    ssm step reads no ``pos``."""
    _require_ported(cfg)

    def decode_step(params, cache, batch):
        with on_mesh(params):
            return _decode(params, cache, batch)

    def _decode(params, cache, batch):
        token, pos = batch["token"], int(batch["pos"])
        if cfg.family == "audio":
            h, _, cache = W.forward_decode(cfg, params, token, cache, pos)
        elif cfg.family == "vlm":
            h, _, cache = V.forward_decode(cfg, params, token, cache, pos)
        elif cfg.family == "ssm":
            h, cache = R.forward(cfg, params, token, "decode", cache=cache)
        elif cfg.family == "hybrid":
            h, _, cache = J.forward(cfg, params, token, "decode",
                                    cache=cache, pos=pos)
        else:
            x = L.embed(cfg, params, token[:, None])
            h, _, cache = T.forward(cfg, params, x, "decode", cache=cache,
                                    pos=pos)
        logits = L.logits_fn(cfg, params, h)
        return cache, logits[:, 0]
    return decode_step


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def loss_fn(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """The mean next-token cross-entropy of ``batch`` ({'tokens',
    'labels'}: [B, S] ints, with ``frames`` or ``patches`` for audio and
    vlm; a vlm's labels cover its text positions) under ``params``: the
    training forward, then ``layers.chunked_lm_loss``, plus
    ``router_aux_loss`` x the router aux loss summed over the MoE layers
    where the config has experts."""
    _require_ported(cfg)
    h, aux, _ = _hidden_and_aux(cfg, params, batch, "train")
    loss = L.chunked_lm_loss(cfg, params, h, batch["labels"])
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_loss * aux
    return loss


def loss_and_grads(cfg: ModelConfig, params, batch):
    """(``loss_fn`` as a plain tensor, {name: its gradient}): what a train
    step feeds the optimizer. On a mesh it runs inside ``on_mesh(params)``
    and the gradients are DTensors on their params' meshes (a partial sum
    where a rank's share is)."""
    names = sorted(params)
    leaves = [params[k].detach().requires_grad_(True) for k in names]
    loss = loss_fn(cfg, dict(zip(names, leaves)), batch)
    if is_dtensor(loss):      # a partial sum: reduce it first
        from torch.distributed.tensor import Replicate
        loss = loss.redistribute(loss.device_mesh, [Replicate()]
                                 * loss.device_mesh.ndim)
    grads = torch.autograd.grad(loss, leaves)
    return _plain(loss.detach()), dict(zip(names, grads))


def _opt_config(cfg: ModelConfig, oc: Optional[AdamWConfig]) -> AdamWConfig:
    return oc or AdamWConfig(moment_dtype=cfg.opt_state_dtype)


def make_train_step(cfg: ModelConfig, oc: Optional[AdamWConfig] = None):
    """train_step(state, batch) -> (new state, {'loss', 'grad_norm',
    'lr'}): the loss and its gradients over the param leaves, then
    ``adamw_update``. With ``cfg.grad_accum`` = g > 1 the batch's rows are
    cut into g micro-batches in order, each one's grads divided by g in
    the params' dtype and summed in ``cfg.opt_state_dtype`` (as the JAX
    ``lax.scan`` over micro-batches), the loss averaged in f32. The state
    given is left as it was."""
    _require_ported(cfg)
    oc = _opt_config(cfg, oc)
    g = max(1, cfg.grad_accum)

    def micro(v, i, b):
        """Rows [i b, (i + 1) b) of every rank's block of v (on a mesh a
        micro-batch takes each rank's share, so no rows move)."""
        if not is_dtensor(v):
            return v[i * b:(i + 1) * b]
        from torch.distributed.tensor import DTensor
        loc = v.to_local()
        bl = loc.shape[0] // g
        return DTensor.from_local(loc[i * bl:(i + 1) * bl], v.device_mesh,
                                  v.placements)

    def train_step(state, batch):
        params = state["params"]
        with on_mesh(params):
            if g == 1:
                loss, grads = loss_and_grads(cfg, params, batch)
            else:
                rows = next(iter(batch.values())).shape[0]
                if rows % g:
                    raise ValueError(f"batch of {rows} rows does not split "
                                     f"into grad_accum = {g} micro-batches")
                b = rows // g
                adt = getattr(torch, cfg.opt_state_dtype)
                grads = {k: zeros_like(p, adt) for k, p in params.items()}
                loss = torch.zeros((), dtype=f32,
                                   device=next(iter(params.values())).device)
                for i in range(g):
                    mb = {k: micro(v, i, b) for k, v in batch.items()}
                    l_, gr = loss_and_grads(cfg, params, mb)
                    for k, a in grads.items():   # in place: one sum alive
                        gk = gr[k]
                        if is_dtensor(gk):
                            gk = gk.redistribute(a.device_mesh, a.placements)
                        a.add_((gk / g).to(a.dtype))
                    loss = loss + l_ / g
                    del gr
            new_params, opt, metrics = adamw_update(params, grads,
                                                    state["opt"], oc)
        metrics["loss"] = loss
        return {"params": new_params, "opt": opt}, metrics

    return train_step


def init_state(cfg: ModelConfig, generator: torch.Generator,
               max_seq: int = 0, oc: Optional[AdamWConfig] = None,
               device=None) -> Dict:
    """{'params', 'opt': {'m', 'v', 'count'}}: ``init_params`` and zero
    moments in the optimizer's moment dtype, with the JAX names."""
    params = init_params(cfg, generator, max_seq, device=device)
    return {"params": params, "opt": adamw_init(params, _opt_config(cfg, oc))}


def state_struct(cfg: ModelConfig, max_seq: int = 0) -> Dict:
    """The train state's {name: (shape, dtype)} tree, nothing allocated."""
    ps = params_struct(cfg, max_seq)
    mdt = getattr(torch, cfg.opt_state_dtype)
    mom = {k: (shape, mdt) for k, (shape, _) in ps.items()}
    return {"params": ps,
            "opt": {"m": mom, "v": dict(mom), "count": ((), torch.int32)}}
