"""The port's resilience subsystem on the CPU: guardrails, the retry
policy, the supervised trainer and its chaos drills, against the JAX
package.

``check_state`` must return the JAX package's violation strings for the
same state, and the policy helpers its values. Each chaos drill (host
loss, device loss, NaN batch, corrupt checkpoint, straggler deadline,
budget exhausted, non-retryable fault, step-0 checkpoint, escalation) must
end bitwise at the port's uninterrupted supervised run, which is itself
bitwise the port's ``trainer.train``. The supervisor's report on the
combined drill of ``chip_smoke.py`` phase 9 (a NaN batch, two host losses
and a corrupt checkpoint) must equal the JAX package's on the same hooks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import IVectorRecipe as JRecipe  # noqa: E402
from repro.configs.ivector_tvm import SMOKE as J_SMOKE  # noqa: E402
from repro.core import guardrails as JGR  # noqa: E402
from repro.core import trainer as JTR  # noqa: E402
from repro.core import tvm as JTV  # noqa: E402
from repro.core import ubm as JU  # noqa: E402
from repro.distributed import fault_tolerance as JFT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import IVectorRecipe as TRecipe  # noqa: E402
from repro_torch.checkpoint import manager as CM  # noqa: E402
from repro_torch.configs.ivector_tvm import SMOKE as T_SMOKE  # noqa: E402
from repro_torch.core import guardrails as GR  # noqa: E402
from repro_torch.core import trainer as TR  # noqa: E402
from repro_torch.core.engine import RESCORE_LADDER  # noqa: E402
from repro_torch.distributed import fault_tolerance as FT  # noqa: E402

CFG = T_SMOKE.with_overrides(n_iters=3)
J_CFG = J_SMOKE.with_overrides(n_iters=3)
SEED = 7


def _gen():
    return torch.Generator().manual_seed(SEED)


@pytest.fixture(scope="module")
def setup():
    """The frames and UBM of ``tests/test_resilience.py``, as numpy."""
    rng = np.random.default_rng(0)
    C, D = CFG.n_components, CFG.feat_dim
    feats = rng.standard_normal((8, 32, D)).astype(np.float32)
    w = np.full((C,), 1.0 / C, np.float32)
    means = rng.standard_normal((C, D)).astype(np.float32)
    covs = np.stack([np.eye(D, dtype=np.float32)] * C)
    return feats, (w, means, covs)


def _tubm(gmm):
    return convert.ubm_from_numpy(*gmm, device="cpu")


def _supervised(setup, d, **kw):
    feats, gmm = setup
    return TR.train_supervised(CFG, _tubm(gmm), feats, generator=_gen(),
                               ckpt_dir=d, device="cpu", **kw)


@pytest.fixture(scope="module")
def reference(setup, tmp_path_factory):
    """Uninterrupted supervised run: the trajectory every drill must
    reproduce bitwise after recovery."""
    state, rep = _supervised(setup, tmp_path_factory.mktemp("ref"))
    assert rep.n_restarts == 0 and not rep.faults
    return state


def _assert_bit_exact(state, reference):
    assert torch.equal(state.model.T, reference.model.T)
    assert torch.equal(state.model.Sigma, reference.model.Sigma)


def test_supervised_run_is_bitwise_train(setup, reference):
    feats, gmm = setup
    state = TR.train(CFG, _tubm(gmm), feats, generator=_gen(),
                     device="cpu")
    _assert_bit_exact(state, reference)
    assert reference.iteration == CFG.n_iters


# ---------------------------------------------------------------------------
# check_state: the JAX package's strings for the same state
# ---------------------------------------------------------------------------


def _state(setup):
    """A good checkpoint tree as numpy leaves (the JAX model drawn from
    the JAX key, so both packages check the same numbers)."""
    _, (w, means, covs) = setup
    m = JTV.init_model(jax.random.PRNGKey(SEED), means, covs,
                       CFG.ivector_dim, CFG.formulation, CFG.prior_offset)
    C, D = means.shape
    return {"T": np.asarray(m.T).copy(), "Sigma": np.asarray(m.Sigma).copy(),
            "prior": np.asarray(m.prior), "mmeans": np.asarray(m.means),
            "w": w.copy(), "means": means.copy(), "covs": covs.copy(),
            "n": np.zeros((C,), np.float32),
            "f": np.zeros((C, D), np.float32),
            "ss": np.zeros((C, D, D), np.float32)}


def _trees(s):
    jm = JTV.TVModel(T=s["T"], Sigma=s["Sigma"], prior=s["prior"],
                     means=s["mmeans"], formulation=CFG.formulation)
    jtree = {"model": jm, "ubm": JU.FullGMM(s["w"], s["means"], s["covs"]),
             "n": s["n"], "f": s["f"], "ss": s["ss"]}
    tm = convert.tvm_from_numpy(s["T"], s["Sigma"], s["prior"], s["mmeans"],
                                CFG.formulation, device="cpu")
    ttree = {"model": tm,
             "ubm": convert.ubm_from_numpy(s["w"], s["means"], s["covs"],
                                           device="cpu"),
             **{k: torch.from_numpy(s[k]) for k in ("n", "f", "ss")}}
    return jtree, ttree


def _set(key, idx, value):
    def mutate(s):
        s[key][idx] = value
    return mutate


def _scale(key, value):
    def mutate(s):
        s[key] *= value
    return mutate


def _not_pd(key, c, v):
    def mutate(s):
        s[key][c, 0, 1] = s[key][c, 1, 0] = v
    return mutate


MUTATIONS = {
    "good": [],
    "T_all_nan": [_scale("T", np.nan)],
    "T_some_nan": [_set("T", (0, 0, slice(0, 3)), np.nan)],
    "Sigma_inf": [_set("Sigma", (1, 2, 2), np.inf)],
    "Sigma_diag_floor": [_set("Sigma", (0, 0, 0), -1.0)],
    "Sigma_not_pd": [_not_pd("Sigma", 3, 2.0)],
    "weights_negative": [_set("w", 0, -0.5)],
    "weights_off_simplex": [_scale("w", 2.0)],
    "weights_nan": [_set("w", 3, np.nan)],
    "ubm_means_nan": [_set("means", (2, 1), np.nan)],
    "covs_floor": [_set("covs", (0, 0, 0), -1.0)],
    "covs_not_pd": [_not_pd("covs", 1, 3.0)],
    "covs_nan_and_negative_weight": [_set("covs", (4, 1, 1), np.nan),
                                     _set("w", 2, -0.25)],
    "stats_n_negative": [_set("n", 0, -1.0)],
    "stats_f_nan_ss_inf": [_set("f", (1, 1), np.nan),
                           _set("ss", (2, 0, 0), np.inf)],
    "stats_n_nan_and_negative": [_set("n", 0, -1.0), _set("n", 1, np.nan)],
    "everything": [_scale("T", np.nan), _not_pd("Sigma", 0, 2.0),
                   _set("w", 0, -0.5), _not_pd("covs", 1, 3.0),
                   _set("n", 5, -2.0)],
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_check_state_strings_match_jax(setup, name):
    s = _state(setup)
    for mutate in MUTATIONS[name]:
        mutate(s)
    jtree, ttree = _trees(s)
    want = JGR.check_state(jtree)
    assert GR.check_state(ttree) == want
    assert bool(want) == (name != "good")


@pytest.mark.parametrize("metrics,prev", [
    ({"avg_loglik": -10.0}, {"avg_loglik": -10.2}),
    ({"avg_loglik": -200.0}, {"avg_loglik": -10.0}),
    ({"avg_loglik": float("nan")}, None),
    ({"avg_loglik": -0.9}, {"avg_loglik": -0.2}),
    ({"avg_loglik": -3.0}, {"avg_loglik": float("inf")}),
], ids=["steady", "diverged", "nan", "small_scale", "prev_inf"])
def test_check_state_loglik_watchdog_matches_jax(setup, metrics, prev):
    jtree, ttree = _trees(_state(setup))
    want = JGR.check_state(jtree, metrics, prev)
    tm = {k: torch.tensor(v) for k, v in metrics.items()}
    assert GR.check_state(ttree, tm, prev) == want


def test_guardrail_hook_resets_on_rollback(setup):
    _, tree = _trees(_state(setup))
    hook = GR.make_guardrail()
    assert hook(tree, {"avg_loglik": torch.tensor(-10.0)}) == []
    assert any("diverged" in v
               for v in hook(tree, {"avg_loglik": torch.tensor(-999.0)}))
    hook.reset()
    assert hook(tree, {"avg_loglik": -999.0}) == []


# ---------------------------------------------------------------------------
# Policy helpers: the JAX package's values
# ---------------------------------------------------------------------------


def test_escalation_ladder_matches_jax():
    for over in (dict(estep_dtype="bfloat16", rescore="fused"),
                 dict(rescore="fused"), dict(rescore="sparse"),
                 dict(rescore="dense"), dict(estep_dtype="bfloat16")):
        got = [(c.estep_dtype, c.rescore)
               for c in GR.escalation_ladder(T_SMOKE.with_overrides(**over))]
        want = [(c.estep_dtype, c.rescore)
                for c in JGR.escalation_ladder(J_SMOKE.with_overrides(**over))]
        assert got == want
    assert got == [("float32", "sparse"), ("float32", "dense")]
    assert GR.escalate_config(T_SMOKE.with_overrides(rescore="dense")) \
        is None
    assert RESCORE_LADDER == ("fused", "sparse", "dense")


def test_retry_policy_matches_jax():
    for kw in (dict(), dict(backoff=0.5, backoff_cap=4.0, jitter=0.25),
               dict(backoff=0.1, backoff_cap=30.0, jitter=0.5,
                    max_restarts=3, step_deadline=2.0, escalate_after=1)):
        p, jp = FT.RetryPolicy(**kw), JFT.RetryPolicy(**kw)
        assert [p.delay(k) for k in range(1, 9)] == \
            [jp.delay(k) for k in range(1, 9)]
        assert p.describe() == jp.describe()
    d = [FT.RetryPolicy(backoff=0.5, backoff_cap=4.0).delay(k)
         for k in (4, 5, 6)]
    assert len(set(d)) == 3           # jitter de-synchronises equal bases


def test_shard_for_host_matches_jax():
    remaps = (None, {}, {2: 5, 6: 0})
    for step in (0, 7):
        for host in range(12):
            for remap in remaps:
                assert FT.shard_for_host(step, host, 8, remap) == \
                    JFT.shard_for_host(step, host, 8, remap)
    assert FT.shard_for_host(7, 2, 8, {2: 5, 6: 0}) == 5


# ---------------------------------------------------------------------------
# Training drills: one per fault class, each bitwise at the reference
# ---------------------------------------------------------------------------


def test_chaos_drill_host_loss_bit_exact(setup, reference, tmp_path):
    chaos = FT.Chaos(fail_at=lambda s, a: s == 2 and a == 0)
    state, rep = _supervised(setup, tmp_path, chaos=chaos)
    assert rep.n_restarts == 1
    assert [f["type"] for f in rep.faults] == ["InjectedFailure"]
    assert rep.faults[0]["recovery_s"] is not None
    _assert_bit_exact(state, reference)


def test_chaos_drill_device_loss_mid_step(setup, reference, tmp_path):
    chaos = FT.Chaos(device_loss_at=lambda s, a: s == 1 and a == 0)
    state, rep = _supervised(setup, tmp_path, chaos=chaos)
    assert rep.n_restarts == 1
    _assert_bit_exact(state, reference)


def test_chaos_drill_nan_batch_guardrail_rollback(setup, reference,
                                                  tmp_path):
    """A NaN batch: the guardrail rolls the step back before its
    checkpoint, so every on-disk step still verifies."""
    chaos = FT.Chaos(poison_at=lambda s, a: s == 1 and a == 0)
    state, rep = _supervised(setup, tmp_path, chaos=chaos)
    assert rep.rollbacks == 1
    assert [f["type"] for f in rep.faults] == ["GuardrailViolation"]
    ckpt = CM.CheckpointManager(tmp_path, device="cpu")
    for s in ckpt.steps():
        ckpt.verify_step(s)
    _assert_bit_exact(state, reference)


def test_nan_batch_without_guardrail_raises(setup, tmp_path):
    """Without a guardrail the port's factorization error on a NaN batch
    propagates: it is not a fault the supervisor retries."""
    feats, gmm = setup
    with pytest.raises(torch.linalg.LinAlgError):
        TR.train_supervised(
            CFG.with_overrides(guardrail=False), _tubm(gmm), feats,
            generator=_gen(), ckpt_dir=tmp_path, device="cpu",
            chaos=FT.Chaos(poison_at=lambda s, a: s == 1 and a == 0))


def test_chaos_drill_corrupted_checkpoint(setup, reference, tmp_path):
    chaos = FT.Chaos(corrupt_ckpt_at=lambda s, a: s == 2 and a == 0,
                     fail_at=lambda s, a: s == 3 and a == 0)
    state, rep = _supervised(setup, tmp_path, chaos=chaos)
    assert rep.skipped_corrupt == [2]
    assert rep.n_restarts == 1
    _assert_bit_exact(state, reference)


def test_chaos_drill_straggler_deadline(setup, reference, tmp_path):
    policy = FT.RetryPolicy(max_restarts=5, step_deadline=60.0)
    chaos = FT.Chaos(
        delay_at=lambda s, a: 120.0 if (s == 1 and a == 0) else 0.0)
    state, rep = _supervised(setup, tmp_path, policy=policy, chaos=chaos)
    assert [f["type"] for f in rep.faults] == ["DeadlineExceeded"]
    _assert_bit_exact(state, reference)


def test_chaos_restart_budget_exhausted(setup, tmp_path):
    with pytest.raises(FT.InjectedFailure):
        _supervised(setup, tmp_path, max_restarts=2,
                    chaos=FT.Chaos(fail_at=lambda s, a: s == 1))


PHASE9_HOOKS = dict(poison_at=lambda s, a: (s, a) == (1, 0),
                    fail_at=lambda s, a: (s, a) in ((2, 1), (3, 2)),
                    corrupt_ckpt_at=lambda s, a: (s, a) == (2, 2))


def test_combined_drill_matches_jax_supervisor(setup, reference, tmp_path):
    """The hooks of chip_smoke.py phase 9: a NaN batch rolled back, a
    host lost after step 1, then a corrupted step-2 checkpoint and a host
    lost after step 2, so the last restore skips step 2. The port's
    report equals the JAX supervisor's on the same hooks (recovery times
    apart) and the run ends bitwise at the reference."""
    state, rep = _supervised(setup, tmp_path / "t",
                             chaos=FT.Chaos(**PHASE9_HOOKS))
    feats, gmm = setup
    _, jrep = JTR.train_supervised(
        J_CFG, JU.FullGMM(*gmm), feats, key=jax.random.PRNGKey(SEED),
        ckpt_dir=tmp_path / "j", chaos=JFT.Chaos(**PHASE9_HOOKS))

    def summary(r):
        return (r.final_step, r.n_restarts, r.rollbacks, r.escalations,
                r.skipped_corrupt,
                [(f["type"], f["step"], f["attempt"]) for f in r.faults])

    assert summary(rep) == summary(jrep)
    assert summary(rep)[1:] == (3, 1, 0, [2], [
        ("GuardrailViolation", 1, 0), ("InjectedFailure", 2, 1),
        ("InjectedFailure", 3, 2)])
    _assert_bit_exact(state, reference)


# ---------------------------------------------------------------------------
# Supervisor-level drills (toy state)
# ---------------------------------------------------------------------------


def _ckpt(d, **kw):
    return CM.CheckpointManager(d, device="cpu", **kw)


def test_escalation_swaps_step_fn(tmp_path):
    """A step that keeps violating escalates after ``escalate_after``
    consecutive rollbacks, and the escalated step completes the run."""
    calls = {"bad": 0, "good": 0}

    def bad_step(state, batch):
        calls["bad"] += 1
        return {"x": state["x"] * float("nan")}, {}

    def good_step(state, batch):
        calls["good"] += 1
        return {"x": state["x"] + 1.0}, {}

    def guardrail(state, metrics):
        return [] if torch.isfinite(state["x"]).all() else ["x non-finite"]

    rep = FT.run_supervised(
        init_state_fn=lambda: {"x": torch.zeros(2)},
        train_step_fn=bad_step, data_factory=TR._StepFeed, n_steps=2,
        ckpt=_ckpt(tmp_path, save_interval=1, keep=3),
        policy=FT.RetryPolicy(max_restarts=6, escalate_after=2),
        guardrail=guardrail, on_escalate=lambda: good_step)
    assert rep.final_step == 2 and rep.escalations == 1
    assert rep.rollbacks == 2 and calls == {"bad": 2, "good": 2}


def test_trainer_escalates_down_the_ladder(setup, tmp_path):
    """In the trainer, a step that keeps failing on the fused rung moves
    to the next config of the ladder after ``escalate_after`` rollbacks."""
    seen = []

    def guardrail(tree, metrics):
        seen.append(float(metrics["avg_loglik"]))
        return ["forced"] if len(seen) <= 2 else []

    feats, gmm = setup
    cfg = CFG.with_overrides(rescore="fused", n_iters=1)
    _, rep = TR.train_supervised(cfg, _tubm(gmm), feats, generator=_gen(),
                                 ckpt_dir=tmp_path, device="cpu",
                                 guardrail=guardrail)
    assert rep.rollbacks == 2 and rep.escalations == 1
    assert rep.final_step == 1 and rep.n_restarts == 2


def test_supervisor_sleeps_backoff(tmp_path):
    slept = []
    rep = FT.run_supervised(
        init_state_fn=lambda: {"x": torch.zeros(1)},
        train_step_fn=lambda s, b: ({"x": s["x"] + 1.0}, {}),
        data_factory=TR._StepFeed, n_steps=3,
        ckpt=_ckpt(tmp_path, save_interval=1, keep=2),
        chaos=FT.Chaos(fail_at=lambda s, a: s == 1 and a < 2),
        policy=FT.RetryPolicy(max_restarts=5, backoff=0.25),
        sleep=slept.append)
    assert rep.n_restarts == 2
    assert len(slept) == 2 and slept[1] > slept[0] >= 0.25


def test_nonretryable_propagates(tmp_path):
    def boom(state, batch):
        raise ZeroDivisionError("a real bug, not a fault")

    with pytest.raises(ZeroDivisionError):
        FT.run_supervised(
            init_state_fn=lambda: {"x": torch.zeros(1)},
            train_step_fn=boom, data_factory=TR._StepFeed, n_steps=1,
            ckpt=_ckpt(tmp_path, save_interval=1))


class _RecordingFeed(TR._StepFeed):
    restored_with = None

    def restore(self, st):
        _RecordingFeed.restored_with = dict(st)
        super().restore(st)


def test_step0_checkpoint_covers_early_failure(tmp_path):
    """With a sparse save interval, a failure before the first interval
    restarts from the eagerly saved step-0 cursor."""
    _RecordingFeed.restored_with = None
    rep = FT.run_supervised(
        init_state_fn=lambda: {"x": torch.zeros(1)},
        train_step_fn=lambda s, b: ({"x": s["x"] + b["gain"]}, {}),
        data_factory=_RecordingFeed, n_steps=3,
        ckpt=_ckpt(tmp_path, save_interval=5, keep=3),
        chaos=FT.Chaos(fail_at=lambda s, a: s == 2 and a == 0))
    assert _RecordingFeed.restored_with == {"step": 0}
    assert rep.final_step == 3 and rep.n_restarts == 1
    assert 0 in CM.all_steps(tmp_path)


def test_corrupt_latest_checkpoint(tmp_path):
    for s in (1, 2):
        CM.save(tmp_path, s, {"x": torch.full((4,), float(s))})
    assert FT.corrupt_latest_checkpoint(tmp_path) == 2
    with pytest.raises(CM.CheckpointCorruption, match="sha256"):
        CM.verify(tmp_path, 2)
    assert CM.latest_verified_step(tmp_path) == 1
    with pytest.raises(FileNotFoundError):
        FT.corrupt_latest_checkpoint(tmp_path / "empty")


def test_train_supervised_refusals(setup, tmp_path):
    feats, gmm = setup
    with pytest.raises(ValueError, match="ckpt_dir"):
        TR.train_supervised(CFG, _tubm(gmm), feats, device="cpu")
    # a one-rank mesh runs and equals the meshless run
    a, _ = TR.train_supervised(CFG, _tubm(gmm), feats, generator=_gen(),
                               ckpt_dir=tmp_path / "plain", device="cpu")
    b, _ = TR.train_supervised(CFG, _tubm(gmm), feats, generator=_gen(),
                               ckpt_dir=tmp_path / "mesh", mesh=(1, 1),
                               device="cpu")
    _assert_bit_exact(b, a)


# ---------------------------------------------------------------------------
# The recipe
# ---------------------------------------------------------------------------


def test_recipe_supervised_provenance_matches_jax(setup, tmp_path):
    """``IVectorRecipe.run(supervised=True)`` records the JAX package's
    ``resilience`` provenance, and its model is bitwise the unsupervised
    run's."""
    feats, gmm = setup
    labels = np.repeat(np.arange(4), 2)
    jr = JRecipe.from_config(J_CFG, stages=("tvm",)).run(
        data=(feats, labels, JU.FullGMM(*gmm)), n_iters=2,
        supervised=True, ckpt_dir=tmp_path / "j")
    recipe = TRecipe.from_config(CFG, stages=("tvm",), device="cpu")
    tr = recipe.run(data=(feats, labels, _tubm(gmm)), n_iters=2,
                    supervised=True, ckpt_dir=tmp_path / "t")
    want = jr.provenance["resilience"]
    assert want["supervised"] is True and "report" in want
    assert tr.provenance["resilience"] == want
    plain = recipe.run(data=(feats, labels, _tubm(gmm)), n_iters=2)
    assert plain.provenance["resilience"]["supervised"] is False
    assert torch.equal(tr.tv.model.T, plain.tv.model.T)
    assert tr.tv.iterations == 2
