"""Fault tolerance: supervised training with checkpoint/restart, a
configurable retry policy, numerical guardrails and chaos injection (the
port of ``repro/distributed/fault_tolerance.py``, on one device or on
every rank of a mesh).

  * restart: state (model + data cursor) restores bit-exactly from the
    last verified checkpoint (corrupted ones are skipped, see
    checkpoint/manager.py), and the step-indexed data feed regenerates the
    in-flight batch deterministically. Step-0 state is checkpointed
    eagerly, so even a failure before the first save interval restarts
    with a recorded cursor.
  * retries: every fault class the supervisor can recover from
    (`RetryPolicy.retryable`) restarts the loop with exponential backoff
    and deterministic jitter; ``max_restarts`` bounds the budget and
    anything non-retryable propagates at once.
  * numerics: an optional ``guardrail`` hook validates the new state after
    every macro-step, before its checkpoint is written. A violation rolls
    the run back to the last good checkpoint; repeated violations at the
    same step escalate the safety ladder via ``on_escalate`` (bf16 -> f32,
    fused -> sparse -> dense) before the restart budget is spent.
  * stragglers: `RetryPolicy.step_deadline` abandons an attempt whose
    macro-step blows its budget and restarts it from the checkpoint;
    `shard_for_host` is the reassignment hook for a slow host's shard.

Chaos drills inject each fault class through the `Chaos` hooks: host loss
after a step (``fail_at``), device loss mid-step (``device_loss_at``), a
NaN batch (``poison_at``), a straggler delay (``delay_at``), and
corruption of a just-written checkpoint (``corrupt_ckpt_at``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointCorruption, CheckpointManager
from repro_torch.checkpoint import manager as CM
from repro_torch.core.guardrails import GuardrailViolation


class InjectedFailure(RuntimeError):
    """Simulated node failure (tests / chaos drills)."""


class DeadlineExceeded(RuntimeError):
    """A macro-step attempt blew its wall-clock budget (hard straggler);
    the attempt is abandoned and the run restarts from the checkpoint."""


# Everything the supervisor knows how to recover from by restarting:
# injected node/device loss, a hard straggler, a numerical violation
# (rollback), and a corrupted checkpoint discovered mid-run. Anything
# else (a real bug) propagates at once.
RETRYABLE_DEFAULT: Tuple[Type[BaseException], ...] = (
    InjectedFailure, DeadlineExceeded, GuardrailViolation,
    CheckpointCorruption)


@dataclass(frozen=True)
class RetryPolicy:
    """What the supervisor retries, how often, and how patiently."""
    max_restarts: int = 10
    # exponential backoff: attempt k sleeps ~ backoff * 2^(k-1) seconds
    # (0 = restart at once), capped at backoff_cap, with a deterministic
    # jitter fraction so drills and restarts are reproducible
    backoff: float = 0.0
    backoff_cap: float = 30.0
    jitter: float = 0.25
    # per-attempt wall-clock budget for one macro-step (hard-straggler
    # kill); 0 = no deadline
    step_deadline: float = 0.0
    # consecutive guardrail rollbacks at the same step before
    # ``on_escalate`` is consulted; 0 = never escalate
    escalate_after: int = 0
    retryable: Tuple[Type[BaseException], ...] = RETRYABLE_DEFAULT

    def delay(self, attempt: int) -> float:
        """Backoff before restart ``attempt`` (1-based), in seconds."""
        if self.backoff <= 0:
            return 0.0
        base = min(self.backoff_cap, self.backoff * 2.0 ** (attempt - 1))
        # Weyl-sequence jitter: equidistributed in [0, 1), reproducible
        frac = (attempt * 0.6180339887498949) % 1.0
        return base * (1.0 + self.jitter * frac)

    def describe(self) -> Dict:
        """JSON-able summary for run provenance (api/recipe.py)."""
        return {"max_restarts": self.max_restarts,
                "backoff": self.backoff, "backoff_cap": self.backoff_cap,
                "jitter": self.jitter, "step_deadline": self.step_deadline,
                "escalate_after": self.escalate_after,
                "retryable": [t.__name__ for t in self.retryable]}


@dataclass(frozen=True)
class Chaos:
    """Fault injectors for drills; every hook takes (step, attempt).
    ``fail_at`` fires after a step executes but before its checkpoint (the
    worst-case host-loss window); ``device_loss_at`` fires mid-step (the
    in-flight update is lost); ``poison_at`` NaNs every float leaf of the
    batch; ``delay_at`` returns straggler seconds added to the step's
    measured time; ``corrupt_ckpt_at`` flips a byte of the checkpoint that
    was just written."""
    fail_at: Optional[Callable[[int, int], bool]] = None
    device_loss_at: Optional[Callable[[int, int], bool]] = None
    poison_at: Optional[Callable[[int, int], bool]] = None
    delay_at: Optional[Callable[[int, int], float]] = None
    corrupt_ckpt_at: Optional[Callable[[int, int], bool]] = None


@dataclass
class SupervisorReport:
    final_step: int
    n_restarts: int
    metrics: Dict
    # one record per recovered fault: {type, step, attempt, recovery_s}
    # (recovery_s = fault -> state-restored wall time; None if the run
    # ended before the restart completed)
    faults: List[Dict] = field(default_factory=list)
    rollbacks: int = 0        # guardrail-triggered restarts
    escalations: int = 0      # safety-ladder rungs taken
    skipped_corrupt: List[int] = field(default_factory=list)


def _poison(batch: Dict) -> Dict:
    """NaN every float leaf of the batch (the NaN-batch injector)."""
    def nan_like(x):
        a = np.asarray(x)
        if a.dtype.kind == "f":
            return np.full_like(a, np.nan)
        return x
    return {k: nan_like(v) for k, v in batch.items()}


def _to_device(batch: Dict, device) -> Dict:
    """Each leaf of the host batch as a tensor on the trainer's device."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def corrupt_checkpoint(step_dir) -> None:
    """Flip one byte in the middle of a checkpoint's array payload
    (chaos injector: simulated bit rot / torn replication)."""
    p = Path(step_dir) / "arrays.npz"
    raw = bytearray(p.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    p.write_bytes(bytes(raw))


def corrupt_latest_checkpoint(ckpt_dir) -> int:
    """Corrupt the newest on-disk checkpoint; returns its step."""
    step = CM.latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    corrupt_checkpoint(Path(ckpt_dir) / f"step_{step:08d}")
    return step


def run_supervised(
    *,
    init_state_fn: Callable[[], Dict],
    train_step_fn: Callable,
    data_factory: Callable[[], "object"],
    n_steps: int,
    ckpt: CheckpointManager,
    fail_at: Optional[Callable[[int, int], bool]] = None,
    max_restarts: int = 10,
    policy: Optional[RetryPolicy] = None,
    guardrail: Optional[Callable] = None,
    on_escalate: Optional[Callable[[], Optional[Callable]]] = None,
    chaos: Optional[Chaos] = None,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    device=None,
    mesh=None,
) -> SupervisorReport:
    """Train ``n_steps`` with checkpoint/restart under the retry policy.

    ``guardrail(new_state, metrics) -> violations`` runs after every step
    and before its checkpoint: a non-empty violation list raises
    `GuardrailViolation`, so a bad state never reaches disk and the
    restart resumes from the last good checkpoint (a ``reset`` attribute,
    if present, is called on every restart so stateful watchdogs compare
    against the right predecessor). ``on_escalate() -> new_train_step_fn``
    is consulted after ``policy.escalate_after`` consecutive guardrail
    rollbacks at the same step; returning None means the ladder is
    exhausted. ``fail_at``/``max_restarts`` are the legacy injected-
    failure interface and fold into ``chaos``/``policy``. With a
    guardrail set, a step that raises `torch.linalg.LinAlgError` (a
    Cholesky or solve of a NaN or indefinite matrix, where the JAX
    package's factorizations return NaN) is rolled back as a violation.

    Each batch leaf reaches ``train_step_fn`` as a tensor on ``device``
    (the CPU when None). ``clock``/``sleep`` are injectable for
    deterministic drills.

    ``mesh`` (a ``launch.mesh.Mesh``; ``ckpt`` built with the same): every
    rank runs this loop on the same replicated state, so every decision
    (a guardrail's, a chaos hook's, a restart) is the same on every rank.
    The ones that read a clock or the checkpoint directory are made so: a
    step's time is the slowest rank's, and every rank looks for a
    checkpoint before a barrier that rank 0's first save waits behind. A
    checkpoint is corrupted by rank 0 alone, as only it writes.
    """
    policy = policy or RetryPolicy(max_restarts=max_restarts)
    chaos = chaos or Chaos()
    if fail_at is not None and chaos.fail_at is None:
        chaos = replace(chaos, fail_at=fail_at)

    attempt = 0
    metrics: Dict = {}
    faults: List[Dict] = []
    rollbacks = escalations = 0
    skipped: List[int] = []
    stuck_step, stuck_count = -1, 0
    fault_t0: Optional[float] = None

    while True:
        # (re)start: restore the newest verified checkpoint, or init.
        # Every rank of a mesh looks before any rank writes (the eager
        # step-0 save below): a rank that looked after rank 0 had saved
        # would restore and enter the first step's collectives while rank
        # 0 waited in the save's barrier, and the two would deadlock
        data = data_factory()
        resume = ckpt.has_checkpoint()
        ckpt.sync()
        if resume:
            state, step0, extra = ckpt.restore_latest_verified(
                init_state_fn())
            skipped.extend(s for s in ckpt.skipped_corrupt
                           if s not in skipped)
            data.restore(extra.get("data", {"step": step0}))
            step = step0
        else:
            state = init_state_fn()
            step = 0
            # eager step-0 save: every restart path, including one that
            # dies before the first save interval, restores a recorded
            # data cursor instead of silently replaying batches
            ckpt.maybe_save(0, state, extra={"data": data.state()},
                            force=True)
        if fault_t0 is not None:
            faults[-1]["recovery_s"] = clock() - fault_t0
            fault_t0 = None
        if guardrail is not None and hasattr(guardrail, "reset"):
            guardrail.reset()
        try:
            while step < n_steps:
                batch = data.next()
                if chaos.poison_at and chaos.poison_at(step, attempt):
                    batch = _poison(batch)
                batch = _to_device(batch, device)
                if (chaos.device_loss_at
                        and chaos.device_loss_at(step, attempt)):
                    raise InjectedFailure(
                        f"device lost mid-step {step}")
                t0 = clock()
                failed: List[str] = []
                try:
                    new_state, metrics = train_step_fn(state, batch)
                except torch.linalg.LinAlgError as e:
                    # the port's factorizations raise where the
                    # reference's return NaN for the guardrail to find:
                    # with a guardrail on, that is the step's violation
                    if guardrail is None:
                        raise
                    failed = [f"step {step}: factorization failed ({e})"]
                elapsed = _slowest(mesh, clock() - t0)
                if chaos.delay_at:
                    elapsed += float(chaos.delay_at(step, attempt))
                if 0 < policy.step_deadline < elapsed:
                    raise DeadlineExceeded(
                        f"step {step} took {elapsed:.3f}s "
                        f"(deadline {policy.step_deadline}s)")
                if guardrail is not None:
                    violations = failed or guardrail(new_state, metrics)
                    if violations:
                        if stuck_step == step:
                            stuck_count += 1
                        else:
                            stuck_step, stuck_count = step, 1
                        raise GuardrailViolation(list(violations))
                state = new_state
                step += 1
                if chaos.fail_at and chaos.fail_at(step, attempt):
                    raise InjectedFailure(f"injected at step {step}")
                saved = ckpt.maybe_save(step, state,
                                        extra={"data": data.state()})
                if (saved is not None and chaos.corrupt_ckpt_at
                        and chaos.corrupt_ckpt_at(step, attempt)):
                    if ckpt.writer:
                        corrupt_checkpoint(saved)
                    ckpt.sync()
            ckpt.maybe_save(step, state, extra={"data": data.state()},
                            force=True)
            return SupervisorReport(
                final_step=step, n_restarts=attempt,
                metrics={k: float(v) for k, v in metrics.items()},
                faults=faults, rollbacks=rollbacks,
                escalations=escalations, skipped_corrupt=skipped)
        except policy.retryable as e:
            attempt += 1
            fault_t0 = clock()
            faults.append({"type": type(e).__name__, "step": step,
                           "attempt": attempt - 1, "recovery_s": None})
            if isinstance(e, GuardrailViolation):
                rollbacks += 1
                if (policy.escalate_after > 0 and on_escalate is not None
                        and stuck_count >= policy.escalate_after):
                    nxt = on_escalate()
                    if nxt is not None:
                        train_step_fn = nxt
                        escalations += 1
                        stuck_step, stuck_count = -1, 0
            if attempt > policy.max_restarts:
                raise
            d = policy.delay(attempt)
            if d > 0:
                sleep(d)
            # fall through: loop restarts from the last good checkpoint


def _slowest(mesh, seconds: float) -> float:
    """The largest of every rank's ``seconds`` (``seconds`` without a
    mesh of several ranks)."""
    if mesh is None or mesh.size == 1:
        return seconds
    t = torch.tensor([seconds], dtype=torch.float64)
    if mesh.backend == "nccl":
        t = t.to(mesh.device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return float(t)


def shard_for_host(step: int, host: int, n_hosts: int,
                   reassignment: Optional[Dict[int, int]] = None) -> int:
    """Straggler mitigation hook: default identity assignment, with an
    optional reassignment map produced by an external health monitor (a
    healthy host computes a straggler's shard for this step)."""
    if reassignment and host in reassignment:
        return reassignment[host]
    return host % n_hosts
