"""Shims over `repro_torch.api` (the port of ``repro/core/pipeline.py``).

The prepare / `TR.train` / `evaluate_state` triple and the ensemble loop
are composed by `repro_torch.api.IVectorRecipe`; these wrappers keep the
JAX package's entry points, delegating every piece of math to the staged
implementation. New code should use `repro_torch.api` directly:

    recipe = IVectorRecipe.from_config(cfg, data_cfg)
    result = recipe.run(seed=0)                # train + backend + EER
    result = recipe.ensemble(seeds=[0, 1, 2])  # paper's mean±std protocol

Each entry point runs on ``device`` (CUDA unless the caller names another).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from repro_torch.api import artifacts as AR
from repro_torch.api import recipe as RC
from repro_torch.configs.ivector_tvm import IVectorConfig
from repro_torch.core import trainer as TR
from repro_torch.data.speech import SpeechDataConfig


def evaluate_state(cfg: IVectorConfig, state: TR.TrainState, feats,
                   labels, seed: int = 0, mask=None, device=None) -> float:
    """EER of a trained extractor on held-out trials (extraction +
    `api.artifacts.evaluate_ivectors`)."""
    ivecs = TR.extract(cfg, state, feats, mask=mask, device=device)
    eer, _ = AR.evaluate_ivectors(cfg, ivecs, labels, seed)
    return eer


def prepare(cfg: IVectorConfig, data_cfg: SpeechDataConfig, seed: int = 0,
            device=None):
    """Build dataset + train the shared UBM (`api.prepare`)."""
    return RC.prepare(cfg, data_cfg, seed=seed, device=device)


def run_variant(cfg: IVectorConfig, feats, labels, ubm,
                n_iters: int, eval_every: int = 1, seed: int = 0,
                device=None) -> Dict:
    """Train one extractor variant; EER curve every ``eval_every`` iters
    (one `recipe.run` with a curve)."""
    r = RC.IVectorRecipe.from_config(cfg, device=device).run(
        data=(feats, labels, ubm), seed=seed, n_iters=n_iters,
        eval_every=eval_every)
    return {"curve": r.curve, "labels": labels}


def run_experiment(cfg: IVectorConfig, data_cfg: SpeechDataConfig,
                   n_iters: int, eval_every: int = 1,
                   seed: int = 0, device=None) -> Dict:
    r = RC.IVectorRecipe.from_config(cfg, data_cfg, device=device).run(
        seed=seed, n_iters=n_iters, eval_every=eval_every)
    return {"curve": r.curve, "labels": r.data[1]}


def run_ensemble(cfg: IVectorConfig, data_cfg: Optional[SpeechDataConfig],
                 seeds: Sequence[int], n_iters: int, eval_every: int = 1,
                 name: str = "ensemble", out_dir=None,
                 feats=None, labels=None, ubm=None, device=None) -> Dict:
    """The paper's multi-run random-start protocol (`recipe.ensemble`).
    Pass either ``data_cfg`` or prebuilt ``feats``/``labels``/``ubm``."""
    data = None if feats is None else (feats, labels, ubm)
    return RC.IVectorRecipe.from_config(cfg, data_cfg, name=name,
                                        device=device).ensemble(
        data=data, seeds=seeds, n_iters=n_iters, eval_every=eval_every,
        name=name, out_dir=out_dir)
