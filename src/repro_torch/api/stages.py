"""The staged pipeline (the port of ``repro/api/stages.py``): a `Stage`
protocol + registry over a `RunContext`.

A stage is a named, swappable unit of the chain

    features -> ubm -> tvm -> backend -> eval

Each stage reads what it needs from the `RunContext` and writes one typed
artifact back (api/artifacts.py); a stage whose artifact is already
present (e.g. a UBM shared across seeds/variants) is skipped.

Registering a custom stage:

    @register_stage
    class MyStage:
        name = "my-stage"
        def run(self, ctx): ...; return ctx

    IVectorRecipe.from_config(cfg, stages=("features", "ubm", "tvm",
                                           "my-stage", "backend", "eval"))

Stages mutate and return the same context object (the scratchpad of one
`recipe.run`, never shared). Seeds as in the JAX package: the UBM draws
from ``torch.Generator().manual_seed(seed)``, the T initialisation from
``manual_seed(seed + 100)``, the trials from ``np.random.default_rng(seed)``
(the same trials as the JAX package's). Everything runs on ``ctx.device``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Protocol, Tuple

import numpy as np
import torch

from repro_torch.api import artifacts as AR
from repro_torch.configs.ivector_tvm import IVectorConfig
from repro_torch.core import trainer as TR
from repro_torch.core import ubm as U
from repro_torch.data.speech import SpeechDataConfig, build_dataset
from repro_torch.launch import mesh as MS


@dataclass
class RunContext:
    """Mutable scratchpad one `recipe.run` threads through its stages."""
    cfg: IVectorConfig
    seed: int = 0
    n_iters: Optional[int] = None
    eval_every: int = 0                  # 0 = final eval only (no curve)
    data_cfg: Optional[SpeechDataConfig] = None
    device: Optional[torch.device] = None
    # data plane
    feats: Optional[torch.Tensor] = None    # [U, F, D]
    labels: Optional[np.ndarray] = None     # [U]
    mask: Optional[torch.Tensor] = None     # [U, F] or None
    # artifacts (each produced by its stage; pre-filled => stage skipped)
    ubm: Optional[AR.UBMArtifact] = None
    tv: Optional[AR.TVArtifact] = None
    backend: Optional[AR.BackendArtifact] = None
    # derived outputs
    ivectors: Optional[torch.Tensor] = None
    projected: Optional[np.ndarray] = None
    curve: List[Tuple[int, float]] = field(default_factory=list)
    metrics: Dict[str, float] = field(default_factory=dict)
    # checkpointing (threaded into the trainer by the tvm stage)
    ckpt_dir: Optional[str] = None
    ckpt_interval: int = 1
    # supervised tvm stage (trainer.train_supervised: retry policy +
    # numerical guardrails + verified-checkpoint restart); the report of
    # what the supervisor did lands here
    supervised: bool = False
    supervisor_report: Optional[object] = None
    # the trainer substrate (launch.mesh: a Mesh, a (data, model) tuple,
    # or None for cfg.mesh / the default mesh)
    mesh: Optional[object] = None
    # set by the recipe when backend+eval stages follow the tvm stage:
    # the curve's final point is then taken from their result instead of
    # re-extracting and re-fitting inside the training callback
    defer_final_eval: bool = False

    @property
    def state(self) -> Optional[TR.TrainState]:
        """`TrainState` view of the tvm artifact."""
        if self.tv is None:
            return None
        return TR.TrainState(model=self.tv.model, ubm=self.tv.ubm,
                             iteration=self.tv.iterations)


class Stage(Protocol):
    """One named, swappable unit of the pipeline."""
    name: str

    def run(self, ctx: RunContext) -> RunContext: ...


STAGE_REGISTRY: Dict[str, Callable[[], Stage]] = {}


def register_stage(cls):
    """Class decorator: make a stage available to recipes by name."""
    STAGE_REGISTRY[cls.name] = cls
    return cls


def resolve_stages(names) -> Tuple[Stage, ...]:
    """Stage names / instances -> instantiated stage tuple."""
    out = []
    for s in names:
        if isinstance(s, str):
            if s not in STAGE_REGISTRY:
                raise KeyError(
                    f"unknown stage {s!r}; registered: "
                    f"{sorted(STAGE_REGISTRY)}")
            out.append(STAGE_REGISTRY[s]())
        else:
            out.append(s)
    return tuple(out)


# ---------------------------------------------------------------------------
# Canonical stages
# ---------------------------------------------------------------------------


@register_stage
class FeaturesStage:
    """Builds the [U, F, D] feature block + labels from ``ctx.data_cfg``
    (no-op when features were passed in directly)."""
    name = "features"

    def run(self, ctx: RunContext) -> RunContext:
        if ctx.feats is not None:
            return ctx
        if ctx.data_cfg is None:
            raise ValueError("features stage needs data_cfg or "
                             "pre-supplied feats/labels")
        ctx.feats, ctx.labels = build_dataset(ctx.data_cfg, ctx.device)
        return ctx


@register_stage
class UBMStage:
    """Trains the full-covariance UBM on all frames (`train_ubm`'s
    defaults, top_k=0 included); skipped when a UBM artifact is already
    present (shared across variants/seeds)."""
    name = "ubm"

    def run(self, ctx: RunContext) -> RunContext:
        if ctx.ubm is not None:
            return ctx
        frames = ctx.feats.reshape(-1, ctx.feats.shape[-1])
        fmask = None if ctx.mask is None else ctx.mask.reshape(-1)
        mesh = None
        if ctx.mesh is not None or ctx.cfg.mesh is not None:
            mesh = MS.resolve_mesh(
                ctx.mesh if ctx.mesh is not None else ctx.cfg.mesh,
                device=ctx.device)
        gmm = U.train_ubm(frames, ctx.cfg.n_components,
                          torch.Generator().manual_seed(ctx.seed),
                          mask=fmask, mesh=mesh, device=ctx.device)
        ctx.ubm = AR.UBMArtifact(gmm, meta={"seed": ctx.seed,
                                            "n_frames": int(frames.shape[0])})
        return ctx


@register_stage
class TVMStage:
    """Trains the total-variability model (the §3.2 loop, with the
    realignment write-back) from the UBM artifact. With ``eval_every > 0``
    an EER curve is collected during training (the paper's Fig. 2/3
    measurement)."""
    name = "tvm"

    def run(self, ctx: RunContext) -> RunContext:
        if ctx.tv is not None:
            return ctx
        cfg, n_iters = ctx.cfg, ctx.n_iters or ctx.cfg.n_iters
        callback = None
        if ctx.eval_every > 0:
            def callback(state, diag):
                it = state.iteration
                if it == n_iters and ctx.defer_final_eval:
                    return   # final point appended from the eval stage
                if it % ctx.eval_every == 0 or it == n_iters:
                    ivecs = TR.extract(cfg, state, ctx.feats, mask=ctx.mask,
                                       mesh=ctx.mesh, device=ctx.device)
                    e, _ = AR.evaluate_ivectors(cfg, ivecs, ctx.labels,
                                                ctx.seed)
                    ctx.curve.append((it, e))
        generator = torch.Generator().manual_seed(ctx.seed + 100)
        if ctx.supervised:
            # guardrailed, checkpoint-every-step elastic path; the EER
            # curve is not collected here (the supervisor owns the step
            # loop), so eval_every applies to the final point only
            if ctx.ckpt_dir is None:
                raise ValueError("supervised tvm stage requires ckpt_dir")
            state, report = TR.train_supervised(
                cfg, ctx.ubm.ubm, ctx.feats, n_iters=n_iters,
                generator=generator, mask=ctx.mask, ckpt_dir=ctx.ckpt_dir,
                mesh=ctx.mesh, device=ctx.device)
            ctx.supervisor_report = report
        else:
            state = TR.train(cfg, ctx.ubm.ubm, ctx.feats, n_iters=n_iters,
                             generator=generator, callback=callback,
                             mask=ctx.mask, ckpt_dir=ctx.ckpt_dir,
                             ckpt_interval=ctx.ckpt_interval,
                             mesh=ctx.mesh, device=ctx.device)
        ctx.tv = AR.TVArtifact(model=state.model, ubm=state.ubm,
                               iterations=state.iteration,
                               meta={"seed": ctx.seed,
                                     "formulation": cfg.formulation,
                                     "n_iters": state.iteration})
        return ctx


@register_stage
class BackendStage:
    """Extracts training i-vectors and fits the scoring chain
    (centring -> optional whitening -> length-norm -> LDA -> PLDA)."""
    name = "backend"

    def run(self, ctx: RunContext) -> RunContext:
        ctx.ivectors = TR.extract(ctx.cfg, ctx.state, ctx.feats,
                                  mask=ctx.mask, mesh=ctx.mesh,
                                  device=ctx.device)
        if ctx.backend is None:
            ctx.backend = AR.train_backend(ctx.cfg, ctx.ivectors,
                                           ctx.labels)
        ctx.projected = AR.apply_backend(ctx.backend,
                                         ctx.ivectors).cpu().numpy()
        return ctx


@register_stage
class EvalStage:
    """Trial EER over the projected i-vectors (trial draw seeded by
    ``ctx.seed``, matching `evaluate_state`)."""
    name = "eval"

    def run(self, ctx: RunContext) -> RunContext:
        ctx.metrics["eer"] = AR.evaluate_projected(
            ctx.backend, ctx.projected, ctx.labels, ctx.seed)
        return ctx
