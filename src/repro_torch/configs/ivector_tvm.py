"""The paper's own model: Kaldi-VoxCeleb-scale total-variability i-vector system.

Full config matches the paper's §4.1 setup: 72-dim MFCC(+deltas) features,
2048-component full-covariance UBM, rank-400 total-variability matrix,
augmented (Kaldi) formulation with prior offset p=100, LDA 400->200, PLDA.

``SMOKE`` is the CPU-scale reduction used by tests and benchmarks.

A copy of ``repro/configs/ivector_tvm.py``: the port keeps its own so that
it imports nothing of the JAX package. The knobs keep their names and
meanings. ``mesh`` selects the trainer's mesh of ranks
(``launch/mesh.py``); the resilience knobs drive
``trainer.train_supervised``; ``utts_per_batch`` and ``frames_per_utt``
size ``launch/ivector_cell.py``'s macro-step. The port does not read
``compute_dtype``.
"""
from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class IVectorConfig:
    arch_id: str = "ivector-tvm"
    family: str = "ivector"
    feat_dim: int = 72           # MFCC + delta + double-delta
    n_components: int = 2048     # UBM Gaussians (full covariance)
    ivector_dim: int = 400       # total-variability rank
    formulation: str = "augmented"  # 'standard' | 'augmented'
    prior_offset: float = 100.0  # Kaldi's p (augmented formulation only)
    min_divergence: bool = True
    update_sigma: bool = True
    realign_interval: int = 0    # 0 = never; k = realign every k EM iters
    # what the §3.2 realignment writes back into the UBM:
    #   'none'  - realignment disabled (write-back is a no-op)
    #   'means' - means from the T column (the paper's step 5)
    #   'full'  - means + weights + PSD-floored covariances refreshed from
    #             the previous iteration's streamed sufficient statistics
    ubm_update: str = "means"
    n_iters: int = 22            # paper: 22 iterations suffice
    # alignment (paper §4.2): top-K pruning + posterior floor + renormalise
    posterior_top_k: int = 20
    posterior_floor: float = 0.025
    # full-covariance scoring of the preselected set (DESIGN.md §8, §12):
    #   'fused'  - the single-kernel alignment pipeline (preselect, top-K,
    #              packed-symmetric rescore; csrc/gmm_align.cu): the same
    #              C/K FLOP cut as 'sparse' with the preselection in the
    #              same launch
    #   'sparse' - rescore only the K selected components
    #              (csrc/gmm_rescore.cu): a C/K (~100x at this scale) FLOP
    #              cut on the hottest path; the pairs are grouped by
    #              component on the card, so each row is read once per
    #              work item of up to 64 pairs; the paper-regime default
    #   'dense'  - score all C densely and gather (vec-trick matmul);
    #              the CPU/reference fallback, wins at small C
    # fallback ladder: fused -> sparse -> dense (DESIGN.md §12)
    rescore: str = "sparse"
    # TVM E-step linear-algebra layout (DESIGN.md §9):
    #   'packed' - symmetric operands (U_c, Phi+φφᵀ, A_c) live as their
    #              packed upper triangles (P = R(R+1)/2) end to end,
    #              unpacking only at the Cholesky/solve boundaries: ~2x
    #              fewer HBM bytes and MXU FLOPs on the two dominant
    #              E-step contractions (kernels/tvm_estep.py)
    #   'dense'  - full [R, R] operands; the reference fallback
    estep: str = "packed"
    # input dtype of the packed E-step contractions ('float32' |
    # 'bfloat16'); accumulation is ALWAYS f32 (preferred_element_type) —
    # bf16 halves the contraction's HBM traffic again on TPU
    estep_dtype: str = "float32"
    # training-batch geometry for the distributed EM step: a large
    # macro-step amortizes the fixed [C,R,R] accumulator reductions
    utts_per_batch: int = 8192   # global; sharded over (pod, data)
    frames_per_utt: int = 1024   # fixed-size frame batches (paper Fig. 1)
    # streaming utterance chunk for the fused align->stats->E-step pass
    # (core/engine.py): bounds both the live frame-resident arrays
    # ([chunk*F, C] posteriors) and the [chunk, R, R] posterior
    # covariances; ragged tails are exact
    estep_chunk: int = 512
    lda_dim: int = 200
    param_dtype: str = "float32"
    # stats/matmul compute dtype; bf16 w/ fp32 accumulation on TPU
    compute_dtype: str = "bfloat16"
    # default trainer substrate (DESIGN.md §11): a (data, model) grid of
    # ranks every macro-step runs on via the engine's mesh mode. None
    # takes the default mesh (one rank without a process group ->
    # bit-identical single-device path). A KNOB, not a stage: it changes where the same
    # math runs, never what the pipeline computes, so saved bundles strip
    # it (api/recipe.py) and provenance records it per run.
    mesh: Optional[Tuple[int, int]] = None
    # --- resilience policy (DESIGN.md §13) ---------------------------------
    # Knobs of the supervised trainer's failure handling; like ``mesh``
    # they change how a run survives faults, never what converged training
    # computes, so bundles strip them and provenance records them per run.
    guardrail: bool = True       # validate state after every macro-step
    # relative per-frame avg-loglik drop tolerated between consecutive
    # macro-steps before the divergence watchdog trips (cliff detector;
    # realignment legitimately moves the objective)
    guardrail_loglik_drop: float = 0.5
    max_restarts: int = 10       # supervisor restart budget per run
    # base of the exponential retry backoff in seconds (attempt k sleeps
    # ~backoff * 2^k plus deterministic jitter); 0 = restart immediately
    retry_backoff: float = 0.0
    # hard-straggler kill: per-attempt wall-clock budget for one macro-step
    # in seconds; 0 = no deadline
    step_deadline: float = 0.0
    # consecutive guardrail rollbacks at the SAME step before the safety
    # ladder escalates the config one rung (bf16->f32, fused->sparse->
    # dense); 0 = roll back and retry unchanged forever
    escalate_after: int = 2

    def __post_init__(self):
        # JSON round-trips (artifact bundles, provenance) turn the tuple
        # into a list; coerce back so the frozen config stays hashable
        # (lru_cached trainer factories key on it).
        if isinstance(self.mesh, list):
            object.__setattr__(self, "mesh", tuple(self.mesh))

    def with_overrides(self, **kw) -> "IVectorConfig":
        """Derived config; unknown knobs raise (dataclass replace) and the
        result is validated — conflicting knob combinations fail HERE, at
        construction, not deep inside the trainer."""
        return replace(self, **kw).validate()

    def validate(self) -> "IVectorConfig":
        """Reject unknown enum values and conflicting knob combinations
        early. Called from ``with_overrides`` and ``IVectorRecipe
        .from_config`` so every config that reaches the trainer, the
        serving session, or a saved bundle is already coherent. Returns
        ``self`` so call sites can chain."""
        problems = []

        def enum(name, allowed):
            v = getattr(self, name)
            if v not in allowed:
                problems.append(f"{name}={v!r} not in {sorted(allowed)}")

        enum("formulation", {"standard", "augmented"})
        enum("ubm_update", {"none", "means", "full"})
        enum("rescore", {"dense", "sparse", "fused"})
        enum("estep", {"dense", "packed"})
        enum("estep_dtype", {"float32", "bfloat16"})
        for name in ("feat_dim", "n_components", "ivector_dim", "n_iters",
                     "estep_chunk", "lda_dim"):
            if getattr(self, name) < 1:
                problems.append(f"{name} must be >= 1, got "
                                f"{getattr(self, name)}")
        if not 1 <= self.posterior_top_k <= self.n_components:
            problems.append(
                f"posterior_top_k={self.posterior_top_k} outside "
                f"[1, n_components={self.n_components}]")
        if not 0.0 <= self.posterior_floor < 1.0:
            problems.append(
                f"posterior_floor={self.posterior_floor} outside [0, 1)")
        # NOTE: lda_dim may exceed ivector_dim — the backend clamps the
        # projection to min(lda_dim, R) by design (a cap, not a conflict).
        if self.realign_interval < 0:
            problems.append(
                f"realign_interval={self.realign_interval} must be >= 0")
        if self.formulation == "augmented" and self.prior_offset <= 0:
            problems.append("augmented formulation requires "
                            f"prior_offset > 0, got {self.prior_offset}")
        # conflicting knobs: combinations the trainer would silently
        # ignore (or worse, half-apply) are configuration errors
        if self.realign_interval > 0 and self.ubm_update == "none":
            problems.append(
                "realign_interval > 0 with ubm_update='none': realignment "
                "is requested but its UBM write-back is disabled")
        if self.realign_interval > 0 and self.formulation == "standard":
            problems.append(
                "realign_interval > 0 with formulation='standard': the "
                "§3.2 realignment loop is defined for the augmented "
                "formulation only")
        if self.mesh is not None:
            m = self.mesh
            if (not isinstance(m, tuple) or len(m) != 2
                    or not all(isinstance(v, int) and v >= 1 for v in m)):
                problems.append(
                    f"mesh={m!r} must be a (data, model) pair of "
                    "positive ints (or None for the auto local mesh)")
            elif self.n_components % m[1]:
                problems.append(
                    f"mesh model extent {m[1]} does not divide "
                    f"n_components={self.n_components}")
        if self.max_restarts < 0:
            problems.append(
                f"max_restarts={self.max_restarts} must be >= 0")
        for name in ("retry_backoff", "step_deadline"):
            if getattr(self, name) < 0:
                problems.append(f"{name}={getattr(self, name)} must be "
                                ">= 0 (0 disables it)")
        if self.guardrail_loglik_drop <= 0:
            problems.append(
                f"guardrail_loglik_drop={self.guardrail_loglik_drop} "
                "must be > 0 (the watchdog is a cliff detector; 'no drop "
                "allowed' would reject legitimate realignment moves)")
        if self.escalate_after < 0:
            problems.append(
                f"escalate_after={self.escalate_after} must be >= 0 "
                "(0 disables ladder escalation)")
        if self.estep_dtype == "bfloat16" and self.estep == "dense":
            problems.append(
                "estep_dtype='bfloat16' with estep='dense': mixed "
                "precision only applies to the packed E-step contractions "
                "(DESIGN.md §9); the dense path would silently ignore it")
        if problems:
            raise ValueError("invalid IVectorConfig: "
                             + "; ".join(problems))
        return self


CONFIG = IVectorConfig()

SMOKE = CONFIG.with_overrides(
    feat_dim=12,
    n_components=32,
    ivector_dim=24,
    posterior_top_k=8,
    utts_per_batch=16,
    frames_per_utt=64,
    lda_dim=8,
    n_iters=3,
    compute_dtype="float32",
)
