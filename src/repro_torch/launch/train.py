"""Training launcher: trains a token LM on the synthetic pipeline, with
checkpoint/restart when given a checkpoint directory.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --smoke --steps 50 --batch 4 --seq 128 --ckpt-dir /tmp/ck

The port of ``repro/launch/train.py``, with the same flags plus
``--device`` (the card unless the caller names another). It trains what
the JAX launcher trains (dense, moe, ssm and hybrid, experts included)
and refuses what it refuses: audio, vlm and ivector, which train through
``models.api.make_train_step`` with their frames or patches. One card
holds the train state of Moonlight's 4 layers or RWKV-6's 8 at their
published widths; a config whose train state is past the card's memory
(Arctic and Jamba with experts at full width among them) exits naming the
number of such cards its state would need, sharded. Params are random,
drawn from a generator seeded with 0.
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import get_config
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.distributed.fault_tolerance import run_supervised
from repro_torch.models import api


def check_trainable(cfg) -> None:
    """Exit for the families the JAX launcher leaves to their own
    examples, as it does."""
    if cfg.family in ("audio", "vlm", "ivector"):
        raise SystemExit("use family-specific examples for audio/vlm/ivector"
                         " (models.api.make_train_step trains audio and vlm "
                         "with their frames or patches)")


def state_bytes(cfg, max_seq: int, rules=None) -> int:
    """The bytes of the params, their gradients and the two moments; with
    ``rules`` (``sharding.make_rules``), one rank's shards of them."""
    st = api.state_struct(cfg, max_seq)
    axes = api.params_axes(cfg, max_seq)

    def nbytes(tree):
        tot = 0
        for k, (s, d) in tree.items():
            n = math.prod(s)
            if rules is not None:
                for e in rules.spec(len(s), axes[k], s):
                    n //= rules.axis_size(e)
            tot += n * d.itemsize
        return tot

    return 2 * nbytes(st["params"]) + nbytes(st["opt"]["m"]) \
        + nbytes(st["opt"]["v"])


def check_fits(cfg, max_seq: int, capacity: int, rules=None) -> None:
    """Exit where the params, their gradients and the two moments alone
    take more than ``capacity`` bytes, one card's memory (with ``rules``,
    a rank's shards of them), naming how many such cards the whole state
    needs at the least, sharded evenly."""
    need = state_bytes(cfg, max_seq, rules)
    if need > capacity:
        whole = state_bytes(cfg, max_seq)
        where = ("a rank's shards of " if rules is not None else "")
        raise SystemExit(
            f"{cfg.arch_id}: {where}params, gradients and moments take "
            f"{need / 1e9:.1f} GB, past the card's {capacity / 1e9:.1f} GB; "
            f"the state needs at least {math.ceil(whole / capacity)} cards "
            f"of this size, sharded (sharding.make_rules on a "
            f"launch.mesh mesh)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-interval", type=int, default=10)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    check_trainable(cfg)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        check_fits(cfg, args.seq,
                   torch.cuda.get_device_properties(dev).total_memory)
    step_fn = api.make_train_step(cfg)
    pipe_cfg = TokenPipelineConfig(vocab_size=cfg.vocab_size,
                                   seq_len=args.seq,
                                   global_batch=args.batch)

    def init():
        # repro-check: disable=SRC002
        g = torch.Generator(device=dev).manual_seed(0)
        return api.init_state(cfg, g, max_seq=args.seq, device=dev)

    t0 = time.time()
    losses = []

    def train_step(state, batch):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        if len(losses) % args.log_every == 0:
            tok_s = args.batch * args.seq * len(losses) / (time.time() - t0)
            print(f"step {len(losses):5d} loss {losses[-1]:.4f} "
                  f"({tok_s:,.0f} tok/s)")
        return state, m

    out = {"losses": losses}
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir,
                                 save_interval=args.ckpt_interval,
                                 device=dev)
        rep = run_supervised(
            init_state_fn=init, train_step_fn=train_step,
            data_factory=lambda: TokenPipeline(pipe_cfg),
            n_steps=args.steps, ckpt=ckpt, device=dev)
        print(f"done at step {rep.final_step}; restarts={rep.n_restarts}")
        out.update(final_step=rep.final_step, n_restarts=rep.n_restarts)
    else:
        state = init()
        pipe = TokenPipeline(pipe_cfg)
        for _ in range(args.steps):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in pipe.next().items()}
            state, _ = train_step(state, batch)
        out.update(final_step=args.steps, n_restarts=0)
    if losses:
        print(f"first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return out


if __name__ == "__main__":
    main()
