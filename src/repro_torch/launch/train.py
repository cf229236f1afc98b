"""Training launcher: trains a token LM on the synthetic pipeline, with
checkpoint/restart when given a checkpoint directory.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --smoke --steps 50 --batch 4 --seq 128 --ckpt-dir /tmp/ck

The port of ``repro/launch/train.py``, with the same flags plus
``--device`` (the card unless the caller names another). Of the JAX
launcher's families (dense, moe, ssm, hybrid) the port trains the dense
decoders and a hybrid without experts. An arch with experts is refused
(ROADMAP.md Queue 1 item 14d), and so is the ssm family: its forward is
ported (``models.api.loss_fn`` runs it on the CPU), but training it on the
card, with audio and vlm, is item 14h. Params are random, drawn from a
generator seeded with 0.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import get_config
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.distributed.fault_tolerance import run_supervised
from repro_torch.models import api


def check_trainable(cfg) -> None:
    """Raise for what the launcher cannot train: the families the JAX
    launcher leaves to their own examples, and what the port lacks."""
    if cfg.family in ("audio", "vlm", "ivector"):
        raise SystemExit("use family-specific examples for audio/vlm/ivector"
                         " (training audio and vlm on the card: ROADMAP.md "
                         "Queue 1 item 14h)")
    if cfg.family not in ("dense", "hybrid"):
        raise NotImplementedError(
            f"{cfg.arch_id}: the launcher does not train the {cfg.family!r} "
            "family: ssm (with audio and vlm) on the card is ROADMAP.md "
            "Queue 1 item 14h, moe item 14d")
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.arch_id}: MoE layers are not ported (ROADMAP.md Queue 1 "
            "item 14d); models.api trains it with moe=None")


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
