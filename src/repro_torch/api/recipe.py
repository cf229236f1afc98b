"""`IVectorRecipe`: the one-call driver for the staged i-vector pipeline
(the port of ``repro/api/recipe.py``).

    recipe = IVectorRecipe.from_config(cfg, data_cfg)
    result = recipe.run(seed=0, bundle_dir="/tmp/bundle")   # -> RecipeResult
    ex = IVectorExtractor.from_bundle(result.bundle_path)   # serve it

`recipe.run(data)` subsumes the prepare / `TR.train` / `evaluate_state`
triple; `recipe.variants(...)` + `recipe.run_variants` make the paper's
§4 variant study a grid call; `recipe.ensemble` is the paper's multi-seed
random-start mean±std protocol. Seed conventions match the JAX package's
(UBM seed, T-init seed + 100, trial rng seed); the trials are the JAX
package's, the UBM and T draws come from torch generators. The recipe runs
on ``device`` (CUDA unless the caller names another).
"""
from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api import artifacts as AR
from repro_torch.api import stages as SG
from repro_torch.api.bundle import Bundle
from repro_torch.configs.ivector_tvm import IVectorConfig
from repro_torch.core import trainer as TR
from repro_torch.data.speech import SpeechDataConfig
from repro_torch.distributed import fault_tolerance as FT
from repro_torch.launch import mesh as MS


@dataclass
class RecipeResult:
    """What one `recipe.run` hands back."""
    cfg: IVectorConfig
    seed: int
    eer: float
    curve: List[Tuple[int, float]]
    ubm: AR.UBMArtifact
    tv: AR.TVArtifact
    backend: AR.BackendArtifact
    ivectors: np.ndarray
    metrics: Dict[str, float]
    provenance: Dict
    bundle_path: Optional[Path] = None

    @property
    def state(self) -> TR.TrainState:
        """`TrainState` view (for code on the trainer's API)."""
        return TR.TrainState(model=self.tv.model, ubm=self.tv.ubm,
                             iteration=self.tv.iterations)

    @property
    def data(self):
        """(feats, labels, ubm) triple for reuse across runs/variants."""
        return self._data

    _data: tuple = None


class IVectorRecipe:
    """Composition of named stages over one `IVectorConfig`."""

    DEFAULT_STAGES = ("features", "ubm", "tvm", "backend", "eval")

    def __init__(self, cfg: IVectorConfig,
                 data_cfg: Optional[SpeechDataConfig] = None,
                 stages: Optional[Sequence] = None,
                 name: str = "recipe",
                 variant: Optional[Dict] = None, device=None):
        self.cfg = cfg.validate()
        self.data_cfg = data_cfg
        self.stage_spec = tuple(stages) if stages is not None \
            else self.DEFAULT_STAGES
        self.stages = SG.resolve_stages(self.stage_spec)
        self.name = name
        self.variant = dict(variant or {})
        self.device = resolve_device(device)

    @classmethod
    def from_config(cls, cfg: IVectorConfig,
                    data_cfg: Optional[SpeechDataConfig] = None,
                    **kw) -> "IVectorRecipe":
        """Compose the canonical stage chain for ``cfg`` (validated)."""
        return cls(cfg, data_cfg=data_cfg, **kw)

    def with_overrides(self, **kw) -> "IVectorRecipe":
        """Same recipe, derived (validated) config; the override set is
        recorded as the new recipe's variant tag."""
        return IVectorRecipe(self.cfg.with_overrides(**kw),
                             data_cfg=self.data_cfg,
                             stages=self.stage_spec,
                             name=_variant_name(kw) or self.name,
                             variant={**self.variant, **kw},
                             device=self.device)

    # -- variant grid -------------------------------------------------------

    def variants(self, **grid) -> List["IVectorRecipe"]:
        """Cartesian product over list-valued config knobs -> one recipe
        per combination, each tagged with its distinct override dict.

        >>> recipe.variants(formulation=["standard", "augmented"],
        ...                 estep=["dense", "packed"])   # 4 recipes
        """
        keys = list(grid)
        axes = [v if isinstance(v, (list, tuple)) else [v]
                for v in grid.values()]
        return [self.with_overrides(**dict(zip(keys, combo)))
                for combo in itertools.product(*axes)]

    # -- running ------------------------------------------------------------

    def run(self, data=None, seed: int = 0, n_iters: Optional[int] = None,
            eval_every: int = 0, bundle_dir=None, mask=None,
            ckpt_dir=None, ckpt_interval: int = 1,
            mesh=None, supervised: bool = False) -> RecipeResult:
        """Drive every stage once; optionally save a versioned bundle.

        ``data``: None (built from ``data_cfg``), ``(feats, labels)``, or
        the ``(feats, labels, ubm)`` triple of `prepare` / a prior
        result's ``.data`` (the shared-UBM multi-variant protocol).

        ``supervised``: run the tvm stage under the fault-tolerance
        supervisor (retry policy + numerical guardrails + verified-
        checkpoint restart; needs ``ckpt_dir``). What the supervisor did
        lands in provenance, never in artifacts.

        ``mesh``: the trainer substrate (a ``launch.mesh.Mesh``, a
        ``(data, model)`` tuple, or None for ``cfg.mesh`` / the default
        mesh). A run-time knob, not a stage: it is threaded through every
        engine entry point, recorded in the run's provenance as the JAX
        package records it, and stripped from saved bundles.
        """
        names = [s.name for s in self.stages]
        ctx = SG.RunContext(cfg=self.cfg, seed=seed, n_iters=n_iters,
                            eval_every=eval_every, data_cfg=self.data_cfg,
                            device=self.device,
                            mask=(None if mask is None else
                                  torch.as_tensor(mask).to(self.device)),
                            ckpt_dir=ckpt_dir,
                            ckpt_interval=ckpt_interval, mesh=mesh,
                            supervised=supervised,
                            defer_final_eval={"backend", "eval"}
                            .issubset(names))
        _feed(ctx, data)
        for stage in self.stages:
            ctx = stage.run(ctx)
        if (ctx.defer_final_eval and eval_every > 0 and ctx.tv is not None
                and "eer" in ctx.metrics):
            # the deferred final curve point (what the training callback
            # would have computed at it == n_iters)
            ctx.curve.append((ctx.tv.iterations, ctx.metrics["eer"]))
        provenance = {
            "schema_version": AR.SCHEMA_VERSION,
            "recipe": self.name,
            "variant": dict(self.variant),
            "seed": int(seed),
            "n_iters": int(ctx.tv.iterations if ctx.tv else 0),
            "stages": [s.name for s in self.stages],
            "mesh": _mesh_provenance(mesh if mesh is not None
                                     else self.cfg.mesh, ctx),
            "device": str(self.device),
            "resilience": _resilience_provenance(self.cfg, ctx),
        }
        result = RecipeResult(
            cfg=self.cfg, seed=seed,
            eer=ctx.metrics.get("eer", float("nan")),
            curve=list(ctx.curve), ubm=ctx.ubm, tv=ctx.tv,
            backend=ctx.backend,
            ivectors=(None if ctx.ivectors is None
                      else ctx.ivectors.cpu().numpy()),
            metrics=dict(ctx.metrics), provenance=provenance)
        result._data = (ctx.feats, ctx.labels, ctx.ubm.ubm
                        if ctx.ubm else None)
        if bundle_dir is not None:
            if ctx.tv is None:
                raise ValueError(
                    "bundle_dir requires a trained TV model, but this "
                    f"recipe's stage chain {names} produced none")
            # the mesh is where a run executed, not what it produced:
            # bundles stay substrate-independent
            bundle = Bundle(cfg=replace(self.cfg, mesh=None),
                            ubm=ctx.tv.ubm,
                            model=ctx.tv.model, backend=ctx.backend,
                            provenance=provenance)
            result.bundle_path = bundle.save(bundle_dir)
        return result

    def run_variants(self, data=None, seed: int = 0,
                     n_iters: Optional[int] = None, eval_every: int = 0,
                     **grid) -> Dict[str, RecipeResult]:
        """Run the full variant grid against shared data + UBM (prepared
        once from this recipe's base config): one `RecipeResult` per
        combination, keyed by variant name, each with its own provenance.
        """
        if data is None:
            data = prepare(self.cfg, self.data_cfg, seed=seed,
                           device=self.device)
        out: Dict[str, RecipeResult] = {}
        for rec in self.variants(**grid):
            out[rec.name] = rec.run(data=data, seed=seed, n_iters=n_iters,
                                    eval_every=eval_every)
        return out

    # -- the paper's ensemble protocol --------------------------------------

    def ensemble(self, data=None, seeds: Sequence[int] = (0,),
                 n_iters: Optional[int] = None, eval_every: int = 1,
                 name: Optional[str] = None, out_dir=None) -> Dict:
        """Multi-run random-start protocol (paper §4): one extractor per
        seed (fresh T init + fresh trial draw; shared data + UBM),
        per-seed EER curves, mean ± std per iteration (and, with
        ``out_dir``, the payload dumped as ``<name>.json``)."""
        name = name or self.name
        if data is None:
            data = prepare(self.cfg, self.data_cfg, seed=int(seeds[0]),
                           device=self.device)
        curves: Dict[str, List] = {}
        for s in seeds:
            r = self.run(data=data, seed=int(s), n_iters=n_iters,
                         eval_every=eval_every)
            curves[str(int(s))] = [(int(it), float(e)) for it, e in r.curve]
        iters = [it for it, _ in next(iter(curves.values()))]
        eers = np.asarray([[e for _, e in curves[str(int(s))]]
                           for s in seeds])
        result = {
            "name": name,
            "seeds": [int(s) for s in seeds],
            "iters": iters,
            "curves": curves,
            "eer_mean": eers.mean(axis=0).tolist(),
            "eer_std": eers.std(axis=0).tolist(),
            "final_eer_mean": float(eers[:, -1].mean()),
            "final_eer_std": float(eers[:, -1].std()),
            "variant": dict(self.variant),
        }
        if out_dir is not None:
            out_dir = Path(out_dir)
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / f"{name}.json").write_text(
                json.dumps(result, indent=2))
        return result


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def prepare(cfg: IVectorConfig, data_cfg: SpeechDataConfig, seed: int = 0,
            device=None):
    """Dataset + shared UBM: returns the (feats, labels, ubm) triple
    `run`/`ensemble` accept as ``data``."""
    ctx = SG.RunContext(cfg=cfg.validate(), seed=seed, data_cfg=data_cfg,
                        device=resolve_device(device))
    ctx = SG.STAGE_REGISTRY["features"]().run(ctx)
    ctx = SG.STAGE_REGISTRY["ubm"]().run(ctx)
    return ctx.feats, ctx.labels, ctx.ubm.ubm


def _resilience_provenance(cfg: IVectorConfig, ctx: SG.RunContext) -> Dict:
    """The run's failure-handling contract: the policy the config
    requested plus, for supervised runs, what the supervisor did
    (restarts, rollbacks, ladder escalations, checkpoints it refused as
    corrupt), with the JAX package's keys. Provenance, not artifact."""
    out = {
        "supervised": bool(ctx.supervised),
        "guardrail": bool(cfg.guardrail),
        "guardrail_loglik_drop": float(cfg.guardrail_loglik_drop),
        "policy": FT.RetryPolicy(
            max_restarts=cfg.max_restarts, backoff=cfg.retry_backoff,
            step_deadline=cfg.step_deadline,
            escalate_after=cfg.escalate_after).describe(),
    }
    rep = ctx.supervisor_report
    if rep is not None:
        out["report"] = {"n_restarts": rep.n_restarts,
                         "rollbacks": rep.rollbacks,
                         "escalations": rep.escalations,
                         "faults": list(rep.faults),
                         "skipped_corrupt": list(rep.skipped_corrupt)}
    return out


def _mesh_provenance(mesh, ctx) -> Optional[list]:
    """((axis, size), ...) descriptor of the substrate this run trained
    on (the trainer's resolution rules), JSON-shaped; None when it cannot
    be resolved here (e.g. no features were built)."""
    try:
        resolved = MS.resolve_mesh(
            mesh,
            n_utts=None if ctx.feats is None else int(ctx.feats.shape[0]),
            n_components=ctx.cfg.n_components, device=ctx.device)
    except (ValueError, TypeError):
        return None
    desc = MS.mesh_descriptor(resolved)
    return None if desc is None else [list(p) for p in desc]


def _feed(ctx: SG.RunContext, data) -> None:
    """Accept the data shapes: None, a SpeechDataConfig, (feats, labels),
    or (feats, labels, ubm); feats go to the run's device."""
    if data is None:
        return
    if isinstance(data, SpeechDataConfig):
        ctx.data_cfg = data
        return
    feats, labels, *rest = data
    ctx.feats = torch.as_tensor(feats).to(ctx.device, torch.float32)
    ctx.labels = np.asarray(labels)
    if rest and rest[0] is not None:
        ubm = rest[0]
        ctx.ubm = ubm if isinstance(ubm, AR.UBMArtifact) \
            else AR.UBMArtifact(ubm, meta={"provided": True})


def _variant_name(overrides: Dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(overrides.items()))
