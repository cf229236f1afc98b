"""Model API of the LM side: param tables, init, cache shapes, and the
prefill and decode steps.

The port of ``repro/models/api.py`` for the families it runs: ``dense``
decoders and the ``hybrid`` (Jamba) stack, both without experts. Other
families raise (ROADMAP.md Queue 1 item 14). Steps are plain functions;
there is no ``jit``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import jamba as J
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

PORTED_FAMILIES = ("dense", "hybrid")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.arch_id}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP.md Queue 1 item 14); ported: {PORTED_FAMILIES}")


def param_table(cfg: ModelConfig, max_seq: int = 0) -> L.ParamTable:
    """``max_seq`` sizes the learned positional table of families that
    have one; neither ported family does."""
    _require_ported(cfg)
    if cfg.family == "hybrid":
        return J.jamba_table(cfg)
    return T.decoder_table(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                max_seq: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """Random params of ``cfg`` in its ``param_dtype``, drawn from
    ``generator`` (which must live on ``device``: CUDA unless the caller
    names another)."""
    dev = resolve_device(device)
    return L.table_init(param_table(cfg, max_seq), generator,
                        L.param_dtype(cfg), dev)


def n_params(cfg: ModelConfig, max_seq: int = 0) -> int:
    tot = 0
    for shape, _, _ in param_table(cfg, max_seq).values():
        n = 1
        for s in shape:
            n *= s
        tot += n
    return tot


def cache_specs(cfg: ModelConfig,
                shape: ShapeConfig) -> Dict[str, Tuple[Tuple, torch.dtype]]:
    """{name: (shape, dtype)} of the decode cache at this shape."""
    _require_ported(cfg)
    dt = L.cfg_dtype(cfg)
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "hybrid":
        return J.cache_struct(cfg, B, S, dt)
    return T.cache_struct(cfg, B, S, dt)


def zero_cache(cfg: ModelConfig, shape: ShapeConfig, device) -> Dict:
    """A decode cache of zeros at this shape, on ``device``."""
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in cache_specs(cfg, shape).items()}


def _hidden(cfg, params, tokens, kind: str, cache=None, pos=None):
    if cfg.family == "hybrid":
        return J.forward(cfg, params, tokens, kind, cache=cache, pos=pos)
    if kind == "decode":
        tokens = tokens[:, None]
    x = L.embed(cfg, params, tokens)
    return T.forward(cfg, params, x, kind, cache=cache, pos=pos)


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(params, {'tokens': [B, S]}) -> (cache or None, logits
    of the last position [B, V] f32). Jamba's prefill returns no cache."""
    _require_ported(cfg)

    def prefill_step(params, batch):
        h, cache = _hidden(cfg, params, batch["tokens"], "prefill")
        logits = L.logits_fn(cfg, params, h[:, -1:])
        return cache, logits[:, 0]
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """decode_step(params, cache, {'token': [B], 'pos': int}) -> (cache,
    logits [B, V] f32). The cache is updated in place and returned."""
    _require_ported(cfg)

    def decode_step(params, cache, batch):
        h, cache = _hidden(cfg, params, batch["token"], "decode",
                           cache=cache, pos=int(batch["pos"]))
        logits = L.logits_fn(cfg, params, h)
        return cache, logits[:, 0]
    return decode_step
