"""Synthetic LM token pipeline: deterministic, step-indexed, shardable.

A copy of ``repro/data/tokens.py`` (numpy only): the same (seed, step,
shard) gives the same batch, bit for bit, in either package.

Every batch is a pure function of (seed, step, shard) — the properties that
make the pipeline fault-tolerant at pod scale:
  * resume: a restarted worker regenerates exactly the batch it crashed on
    (the checkpoint stores only the step counter);
  * straggler takeover: any host can produce any shard's data;
  * elastic: re-sharding = re-partitioning the shard index space.

Tokens follow a deterministic first-order chain (x_{t+1} depends on x_t)
plus noise, so cross-entropy has learnable structure and training loss
decreases — enough signal for convergence/integration tests.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.3   # fraction of positions replaced by uniform noise
    # chain runs over the first ``active_vocab`` ids (0 = full vocab);
    # smaller values make the structure learnable in fewer steps (tests)
    active_vocab: int = 0


class TokenPipeline:
    def __init__(self, cfg: TokenPipelineConfig, shard: int = 0,
                 n_shards: int = 1):
        assert cfg.global_batch % n_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.n_shards = n_shards
        self.step = 0

    def _batch(self, step: int, shard: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b = cfg.global_batch // self.n_shards
        v = cfg.active_vocab or cfg.vocab_size
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, shard]))
        # deterministic affine chain over the (active) vocab ring
        mult = 31
        x = np.empty((b, cfg.seq_len + 1), np.int64)
        x[:, 0] = rng.integers(0, v, b)
        for t in range(cfg.seq_len):
            x[:, t + 1] = (x[:, t] * mult + 7) % v
        noise = rng.random((b, cfg.seq_len + 1)) < cfg.noise
        x = np.where(noise, rng.integers(0, v, x.shape), x)
        return {"tokens": x[:, :-1].astype(np.int32),
                "labels": x[:, 1:].astype(np.int32)}

    def next(self) -> Dict[str, np.ndarray]:
        out = self._batch(self.step, self.shard)
        self.step += 1
        return out

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        return self._batch(step, self.shard)

    # checkpointable cursor -------------------------------------------------
    def state(self) -> Dict:
        return {"step": self.step}

    def restore(self, state: Dict):
        self.step = int(state["step"])
