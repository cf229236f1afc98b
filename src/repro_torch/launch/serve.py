"""Serving launcher: batched prefill + autoregressive decode with KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --smoke --batch 4 --prompt-len 32 --gen 16

The port of ``repro/launch/serve.py``, with the same flags plus
``--device`` (the card unless the caller names another). Params and
prompts are random, drawn from a seeded generator. It serves the JAX
launcher's families: dense, moe and ssm (RWKV-6). The others are refused
as the JAX launcher refuses them: audio and vlm need their frames or
patches (their steps are ``models.api``'s), and a hybrid's (Jamba's)
prefill returns no cache to decode from.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.models import api


def pad_cache(cache, target_len: int):
    """Grow a prefill cache's sequence dim (axis 2) to the serving window
    (every array of 3 or more dims shorter than it there, as the JAX
    ``pad_cache``; not for an ssm's recurrent cache)."""
    def grow(a):
        if a.ndim >= 3 and a.shape[2] < target_len:
            out = a.new_zeros(a.shape[:2] + (target_len,) + a.shape[3:])
            out[:, :, :a.shape[2]] = a
            return out
        return a
    return {k: grow(v) for k, v in cache.items()}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg, batch: int, prompt_len: int, gen: int,
          generator: torch.Generator, device=None):
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode greedily until each row has ``gen`` tokens (``gen - 1`` decode
    steps). Params are drawn from ``generator``, then the prompts.
    Returns a dict: ``tokens`` [batch, gen] (CPU), ``prefill_logits`` and
    ``last_logits`` [batch, V] f32, ``prefill_s`` (prefill and cache
    growth) and ``decode_s`` (host clock, ending in a device synchronise),
    ``params`` and ``prompts``."""
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(
            f"serve.py drives token-LM archs, not {cfg.family!r}: its steps "
            "need frames or patches (models.api.make_prefill_step)")
    if cfg.family not in ("dense", "moe", "ssm"):
        raise NotImplementedError(
            f"serve drives the dense, moe and ssm token LMs, not "
            f"{cfg.family!r}: a hybrid's prefill returns no cache to decode "
            "from")
    dev = resolve_device(device)
    window = prompt_len + gen
    params = api.init_params(cfg, generator, max_seq=window, device=dev)
    prefill = api.make_prefill_step(cfg)
    decode = api.make_decode_step(cfg)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=generator, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    cache, logits = prefill(params, {"tokens": prompts})
    if cfg.family != "ssm":
        cache = pad_cache(cache, window)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    prefill_logits = logits
    tok = torch.argmax(logits, dim=-1)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        cache, logits = decode(params, cache,
                               {"token": tok, "pos": prompt_len + i})
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return {"tokens": torch.stack(out, dim=1).cpu(),
            "prefill_logits": prefill_logits, "last_logits": logits,
            "prefill_s": prefill_s, "decode_s": decode_s, "params": params,
            "prompts": prompts}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device)
    # repro-check: disable=SRC002
    g = torch.Generator(device=dev).manual_seed(0)
    r = serve(cfg, args.batch, args.prompt_len, args.gen, g, dev)
    steps = args.gen - 1
    print(f"prefill: {args.batch}x{args.prompt_len} in {r['prefill_s']:.3f}s; "
          f"decode: {steps} steps in {r['decode_s']:.3f}s "
          f"({args.batch * steps / max(r['decode_s'], 1e-9):.1f} tok/s)")
    print("sample generation (first row):", r["tokens"][0][:12].tolist())


if __name__ == "__main__":
    main()
