"""Numerical guardrails: validate training state at the failure boundary
(the port of ``repro/core/guardrails.py``).

EM here is chaotic (f32 reassociation differences amplify through the
ill-conditioned M-step solves), so a NaN batch or a blown-up covariance
cannot be told apart from a model ten iterations later. The only place to
catch corruption is right after the macro-step that produced it. This
module is that check, as the supervisor's guardrail hook
(`distributed/fault_tolerance.run_supervised`):

  * finiteness of every state leaf (T, Σ, UBM means/covs/weights, the
    carried sufficient statistics),
  * the UBM weight simplex (non-negative, summing to 1),
  * PSD floors: positive Σ/cov diagonals and a Cholesky that succeeds,
  * a log-likelihood divergence watchdog (the streamed avg loglik must
    not fall off a cliff between consecutive macro-steps).

The checks run on the tensors where they live; every count they need
comes to the host in one transfer. The violation strings are the JAX
package's for the same state.

On violation the supervisor raises `GuardrailViolation` before the step's
checkpoint is written and restarts from the last good checkpoint. If the
same step keeps violating, the safety ladder escalates the config one rung
(`escalate_config`: bf16 -> f32 contractions, then fused -> sparse ->
dense rescoring) and retries.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.ivector_tvm import IVectorConfig
from repro_torch.core.engine import degrade_rescore


class GuardrailViolation(RuntimeError):
    """A post-step state check failed; the step's output must be thrown
    away and recomputed from the last good checkpoint."""

    def __init__(self, violations: List[str]):
        super().__init__("; ".join(violations))
        self.violations = list(violations)


@dataclass(frozen=True)
class GuardrailConfig:
    """Thresholds of one guardrail instance (all checks are read-only)."""
    weight_tol: float = 1e-3        # |Σ_c w_c - 1| tolerance
    cov_floor: float = 0.0          # min allowed Σ/cov diagonal (0 = >0)
    # relative drop of the per-frame avg loglik tolerated between
    # consecutive macro-steps; realignment legitimately moves the
    # objective, so this is a cliff detector, not a monotonicity check
    loglik_drop_tol: float = 0.5
    check_psd: bool = True          # Cholesky-based PSD validation


def _psd_failures(mats: torch.Tensor) -> torch.Tensor:
    """How many of the batched matrices fail a Cholesky (``info != 0``,
    or a non-finite factor, where the JAX package's Cholesky gives NaN)."""
    L, info = torch.linalg.cholesky_ex(mats)
    bad = (info != 0) | ~torch.isfinite(L).flatten(-2).all(dim=-1)
    return bad.sum()


class _Counts:
    """Device scalars gathered by name, then read in one transfer."""

    def __init__(self):
        self.names: List[str] = []
        self.vals: List[torch.Tensor] = []

    def add(self, name: str, t: torch.Tensor) -> None:
        self.names.append(name)
        self.vals.append(t.reshape(()))

    def read(self) -> Dict[str, float]:
        if not self.vals:
            return {}
        dev = self.vals[0].device
        host = torch.stack([v.to(dev, torch.float64)
                            for v in self.vals]).tolist()
        return dict(zip(self.names, host))


def _diag(t: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(t, dim1=-2, dim2=-1)


def check_state(tree: Dict, metrics: Optional[Dict] = None,
                prev_metrics: Optional[Dict] = None,
                gcfg: GuardrailConfig = GuardrailConfig()) -> List[str]:
    """Validate one supervised-trainer checkpoint tree (`_ckpt_tree`
    layout: model, ubm, carried n/f/ss). Returns a list of human-readable
    violations; empty means the state is good. Read-only: no state is
    modified."""
    model, ubm = tree.get("model"), tree.get("ubm")
    floor = gcfg.cov_floor
    leaves = {}
    if model is not None:
        leaves["model.T"] = model.T
        leaves["model.Sigma"] = model.Sigma
    if ubm is not None:
        leaves["ubm.means"] = ubm.means
        leaves["ubm.covs"] = ubm.covs
        leaves["ubm.weights"] = ubm.weights
    for k in ("n", "f", "ss"):
        if k in tree:
            leaves[f"stats.{k}"] = tree[k]
    leaves = {k: v for k, v in leaves.items() if v.is_floating_point()}

    c = _Counts()
    for name, t in leaves.items():
        c.add(name, (~torch.isfinite(t)).sum())
    if model is not None:
        c.add("sigma_floor", (_diag(model.Sigma) <= floor).sum())
        if gcfg.check_psd:
            c.add("sigma_psd", _psd_failures(model.Sigma))
    if ubm is not None:
        c.add("w_neg", (ubm.weights < 0).sum())
        c.add("w_sum", ubm.weights.sum())
        if ubm.covs.ndim == 3:
            c.add("covs_floor", (_diag(ubm.covs) <= floor).sum())
            if gcfg.check_psd:
                c.add("covs_psd", _psd_failures(ubm.covs))
    if "n" in tree:
        c.add("n_neg", (tree["n"] < 0).sum())
    got = c.read()

    out: List[str] = []

    def finite(name: str) -> bool:
        if name not in leaves:
            return True
        bad = int(got[name])
        if bad:
            out.append(f"{name}: {bad}/{leaves[name].numel()} non-finite "
                       "entries")
        return not bad

    if model is not None:
        finite("model.T")
        if finite("model.Sigma"):
            if got["sigma_floor"]:
                out.append(f"model.Sigma: {int(got['sigma_floor'])} "
                           f"diagonal entries <= floor {floor}")
            elif gcfg.check_psd and got["sigma_psd"]:
                out.append("model.Sigma: not positive definite "
                           "(Cholesky failed)")
    if ubm is not None:
        finite("ubm.means")
        covs_ok = finite("ubm.covs")
        if finite("ubm.weights"):
            if got["w_neg"]:
                out.append(f"ubm.weights: {int(got['w_neg'])} negative")
            if abs(got["w_sum"] - 1.0) > gcfg.weight_tol:
                out.append(f"ubm.weights: sum {got['w_sum']:.6f} off "
                           f"the simplex (tol {gcfg.weight_tol})")
        if covs_ok and ubm.covs.ndim == 3:
            if got["covs_floor"]:
                out.append(f"ubm.covs: {int(got['covs_floor'])} "
                           f"diagonal entries <= floor {floor}")
            elif gcfg.check_psd and got["covs_psd"]:
                out.append("ubm.covs: not positive definite "
                           "(Cholesky failed)")
    for k in ("n", "f", "ss"):
        finite(f"stats.{k}")
    if "n" in tree and not got.get("stats.n", 0) and got["n_neg"]:
        out.append(f"stats.n: {int(got['n_neg'])} negative occupancies")
    # loglik divergence watchdog: per-frame avg loglik must not cliff
    if metrics is not None:
        ll = metrics.get("avg_loglik")
        if ll is not None:
            ll = float(ll)
            if not np.isfinite(ll):
                out.append(f"avg_loglik non-finite: {ll}")
            elif prev_metrics is not None:
                prev = prev_metrics.get("avg_loglik")
                if prev is not None and np.isfinite(float(prev)):
                    prev = float(prev)
                    drop = prev - ll
                    allowed = gcfg.loglik_drop_tol * max(abs(prev), 1.0)
                    if drop > allowed:
                        out.append(
                            f"avg_loglik diverged: {prev:.4f} -> {ll:.4f} "
                            f"(drop {drop:.4f} > allowed {allowed:.4f})")
    return out


def make_guardrail(gcfg: GuardrailConfig = GuardrailConfig()):
    """The supervisor-shaped hook: ``guardrail(state_tree, metrics) ->
    violations``. Carries the previous step's metrics for the loglik
    watchdog; a restart (rollback) resets the watchdog so the recomputed
    step is compared against its true predecessor."""
    prev: Dict = {}

    def guardrail(tree, metrics) -> List[str]:
        v = check_state(tree, metrics, prev.get("m"), gcfg)
        if not v:
            prev["m"] = (None if metrics is None
                         else {k: float(val) for k, val in metrics.items()
                               if np.ndim(val) == 0})
        return v

    def reset():
        prev.pop("m", None)

    guardrail.reset = reset
    return guardrail


# ---------------------------------------------------------------------------
# The safety ladder: trade speed for safety, one rung at a time, before
# giving up on a run
# ---------------------------------------------------------------------------


def escalate_config(cfg: IVectorConfig) -> Optional[IVectorConfig]:
    """One rung down the safety ladder, or None when fully conservative:

        estep_dtype bf16 -> f32          (mixed precision off first)
        rescore fused -> sparse -> dense (kernel aggressiveness second)

    Each rung changes where the math runs, never what converged training
    would compute (the modes agree to f32 rounding), so escalating mid-run
    keeps the trajectory valid."""
    if cfg.estep_dtype == "bfloat16":
        return cfg.with_overrides(estep_dtype="float32")
    nxt = degrade_rescore(cfg.rescore)
    if nxt is not None:
        return cfg.with_overrides(rescore=nxt)
    return None


def escalation_ladder(cfg: IVectorConfig) -> List[IVectorConfig]:
    """Every config the ladder can reach from ``cfg``, safest last."""
    out = []
    cur = escalate_config(cfg)
    while cur is not None:
        out.append(cur)
        cur = escalate_config(cur)
    return out
