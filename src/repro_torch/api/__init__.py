"""Staged recipe + versioned artifact-bundle API (the port of
``repro/api``): the one import site for driving the i-vector system end
to end.

    from repro_torch.api import IVectorRecipe, Bundle

    recipe = IVectorRecipe.from_config(cfg, data_cfg)
    result = recipe.run(seed=0, bundle_dir="out/bundle")
    ex = IVectorExtractor.from_bundle(result.bundle_path)

The entry points of `core.pipeline` (`prepare`, `run_variant`,
`run_ensemble`, `evaluate_state`) are thin shims over this package.
"""
from repro_torch.api.artifacts import (SCHEMA_VERSION, BackendArtifact,
                                       TVArtifact, UBMArtifact,
                                       apply_backend, evaluate_ivectors,
                                       score_trials, train_backend)
from repro_torch.api.bundle import Bundle, content_hash, peek
from repro_torch.api.recipe import IVectorRecipe, RecipeResult, prepare
from repro_torch.api.stages import (STAGE_REGISTRY, RunContext, Stage,
                                    register_stage, resolve_stages)

__all__ = [
    "SCHEMA_VERSION", "UBMArtifact", "TVArtifact", "BackendArtifact",
    "train_backend", "apply_backend", "score_trials", "evaluate_ivectors",
    "Bundle", "peek", "content_hash",
    "IVectorRecipe", "RecipeResult", "prepare",
    "Stage", "RunContext", "STAGE_REGISTRY", "register_stage",
    "resolve_stages",
]
