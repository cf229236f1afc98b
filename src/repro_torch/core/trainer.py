"""The TVM trainer on one device (the port of ``repro/core/trainer.py``): the
paper's §3.2 training loop, with its variants switchable by the config:

  formulation   'standard' | 'augmented'
  min_divergence / update_sigma / realign_interval / ubm_update

Without realignment the UBM is static, so the frames are aligned once and
the Baum-Welch statistics are reused by every EM iteration (``em_iter``).
With realignment each iteration is one streamed pass through the engine
(``iteration``): utterance chunks go through alignment -> Baum-Welch
statistics -> TVM E-step accumulation, then M-step and min-divergence;
between iterations ``refresh_ubm`` writes the model back into the UBM
('means': the paper's step 5; 'full' also refreshes weights and
covariances from the same streamed statistics).

Long runs checkpoint through `checkpoint/manager.py` (``ckpt_dir``): model
+ UBM + last-pass sufficient statistics are saved every ``ckpt_interval``
iterations, in the JAX package's format, and restored on restart.
`train_supervised` wraps the same macro-step in
`distributed/fault_tolerance.run_supervised`: an injected failure costs
exactly one macro-step and the restart resumes bit-exactly from the last
checkpoint.

Entry points run on ``device`` (CUDA unless the caller names another). A
kernel failure during training raises: the trainer has no demotion ladder.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import manager as CM
from repro_torch.configs.ivector_tvm import IVectorConfig
from repro_torch.core import engine as EN
from repro_torch.core import guardrails as GR
from repro_torch.core import stats as ST
from repro_torch.core import tvm as TV
from repro_torch.core import ubm as U
from repro_torch.distributed import fault_tolerance as FT

f32 = torch.float32


@dataclass
class TrainState:
    model: TV.TVModel
    ubm: U.FullGMM
    iteration: int = 0


def _spec(cfg: IVectorConfig, second_order: bool) -> EN.EngineSpec:
    return EN.EngineSpec(
        n_components=cfg.n_components, top_k=cfg.posterior_top_k,
        floor=cfg.posterior_floor,
        second_order="full" if second_order else None,
        chunk=cfg.estep_chunk, rescore=cfg.rescore)


def stats_ll(cfg: IVectorConfig, ubm: U.FullGMM, feats, mask=None,
             second_order: Optional[bool] = None):
    """feats [U, F, D] -> (BWStats, (loglik, frames)) through the engine
    (the body of the JAX ``make_stats_ll_fn``; with ``second_order=False``
    that of ``make_stats_fn``). S is tracked when the config updates Σ."""
    so = cfg.update_sigma if second_order is None else second_order
    return EN.stream_bw(_spec(cfg, so), EN.pack_ubm(ubm, feats.device),
                        feats, mask)


def _finish_iteration(cfg: IVectorConfig, model: TV.TVModel,
                      tot: EN.UBMStats, acc: TV.EMAccum):
    """M-step + min-divergence from one pass's merged accumulators."""
    S_m = None
    if cfg.update_sigma:
        S_m = tot.ss
        if model.formulation == "standard":
            S_m = ST.center(ST.BWStats(tot.n[None], tot.f[None], tot.ss),
                            model.means).S
    model = TV.m_step(model, acc, S_m, cfg.update_sigma)
    if cfg.min_divergence:
        model = TV.min_divergence(model, acc)
    diag = {"mean_phi_norm": torch.linalg.norm(acc.h / acc.n_utts),
            "avg_loglik": tot.loglik / torch.clamp(tot.frames, min=1.0)}
    return model, diag


def em_iter(cfg: IVectorConfig, model: TV.TVModel, n, f, S_tot):
    """One EM iteration from precomputed Baum-Welch statistics (the body of
    the JAX ``make_em_fn``) -> (new model, diagnostics)."""
    if model.formulation == "standard":
        st = ST.center(ST.BWStats(n, f, S_tot), model.means)
        n_, f_, S_ = st.n, st.f, st.S
    else:
        n_, f_, S_ = n, f, S_tot
    pre = TV.precompute(model, estep=cfg.estep, device=n.device)
    acc = TV.em_accumulate_scan(model, pre, n_, f_, chunk=cfg.estep_chunk,
                                estep_dtype=cfg.estep_dtype)
    model = TV.m_step(model, acc, S_ if cfg.update_sigma else None,
                      cfg.update_sigma)
    if cfg.min_divergence:
        model = TV.min_divergence(model, acc)
    return model, {"mean_phi_norm": torch.linalg.norm(acc.h / acc.n_utts)}


def _iter_accums(cfg: IVectorConfig, spec: EN.EngineSpec,
                 model: TV.TVModel, feat_dim: int):
    pre = TV.precompute(model, estep=cfg.estep, device=model.T.device)
    center = model.means if model.formulation == "standard" else None
    return (EN.TotalsAccum(spec, feat_dim),
            EN.TVMAccum(model, pre, center_means=center,
                        estep_dtype=cfg.estep_dtype))


def iteration(cfg: IVectorConfig, model: TV.TVModel, ubm: U.FullGMM, feats,
              mask=None):
    """One fused streamed EM iteration (the body of the JAX
    ``make_iter_fn``) -> (new model, totals, diagnostics): the engine feeds
    the global sufficient statistics (``TotalsAccum``: the Σ update and
    the UBM refresh) and the TVM E-step (``TVMAccum``) from one pass."""
    track_S = cfg.update_sigma or cfg.ubm_update == "full"
    spec = _spec(cfg, track_S)
    pack = EN.pack_ubm(ubm, feats.device)
    accums = _iter_accums(cfg, spec, model, feats.shape[-1])
    (tot, acc), _ = EN.stream(spec, pack, feats, mask, accums)
    model, diag = _finish_iteration(cfg, model, tot, acc)
    return model, tot, diag


def merge_totals(a: EN.UBMStats, b: EN.UBMStats) -> EN.UBMStats:
    """Associative merge of finalized sufficient statistics (None ss
    merges with None)."""
    return EN.UBMStats(*(None if x is None else x + y
                         for x, y in zip(a, b)))


# ---------------------------------------------------------------------------
# Realignment write-back (§3.2 step 5, generalized)
# ---------------------------------------------------------------------------


def refresh_ubm(cfg: IVectorConfig, model: TV.TVModel, ubm: U.FullGMM,
                totals: Optional[EN.UBMStats], *,
                update_weights: Optional[bool] = None,
                update_covs: Optional[bool] = None) -> U.FullGMM:
    """UBM write-back for realignment. 'means' rewrites only the means from
    the T column; 'full' also refreshes the weights and the (PSD-floored)
    covariances from the previous iteration's streamed statistics. With
    both refresh flags off, 'full' is exactly 'means'."""
    full = cfg.ubm_update == "full"
    update_weights = full if update_weights is None else update_weights
    update_covs = full if update_covs is None else update_covs
    means = TV.updated_ubm_means(model)
    weights, covs = ubm.weights, ubm.covs
    if update_weights:
        weights = U.renormalised_weights(totals.n)
    if update_covs:
        n_safe = torch.clamp(totals.n, min=1e-6)
        fbar = totals.f / n_safe[:, None]
        covs = (totals.ss / n_safe[:, None, None]
                - means[:, :, None] * fbar[:, None, :]
                - fbar[:, :, None] * means[:, None, :]
                + means[:, :, None] * means[:, None, :])
        covs = U.psd_floor(covs)
    return U.FullGMM(weights, means, covs)


def _realign_due(cfg: IVectorConfig, it: int, model: TV.TVModel) -> bool:
    return (cfg.realign_interval > 0 and it > 0
            and it % cfg.realign_interval == 0
            and model.formulation == "augmented"
            and cfg.ubm_update != "none")


# ---------------------------------------------------------------------------
# Training loop + extraction
# ---------------------------------------------------------------------------


def _ckpt_tree(state: TrainState, totals: Optional[EN.UBMStats]):
    """Fixed-structure checkpoint tree, the JAX package's (placeholder
    zeros keep the manifest stable whether or not second-order statistics
    are tracked)."""
    C, D = state.ubm.means.shape
    dev = state.ubm.means.device
    n = torch.zeros((C,), dtype=f32, device=dev)
    f = torch.zeros((C, D), dtype=f32, device=dev)
    ss = torch.zeros((C, D, D), dtype=f32, device=dev)
    if totals is not None:
        n, f = totals.n, totals.f
        if totals.ss is not None:
            ss = totals.ss
    return {"model": state.model, "ubm": state.ubm, "n": n, "f": f, "ss": ss}


def train(cfg: IVectorConfig, ubm: U.FullGMM, feats,
          n_iters: Optional[int] = None,
          generator: Optional[torch.Generator] = None, callback=None,
          mask=None, ckpt_dir=None, ckpt_interval: int = 1,
          ckpt_keep: int = 3, device=None) -> TrainState:
    """The training loop on in-memory features [U, F, D] (``mask`` [U, F]
    marks valid frames, so ragged batches train exactly).

    T is initialised from ``generator`` (a CPU generator seeded 0 when
    none is given, so a run is reproducible on any device). ``callback``
    gets (state, diagnostics) after every iteration. With ``ckpt_dir`` the
    loop saves model + UBM + last-pass statistics every ``ckpt_interval``
    iterations (keeping ``ckpt_keep``) and resumes from the newest
    checkpoint that verifies: the trajectory is bitwise that of an
    uninterrupted run on the same device.
    """
    dev = resolve_device(device)
    feats = torch.as_tensor(feats).to(dev, f32)
    mask = None if mask is None else torch.as_tensor(mask).to(dev)
    generator = (generator if generator is not None
                 else torch.Generator().manual_seed(0))
    ubm = ubm.to(dev)
    model = TV.init_model(generator, ubm.means, ubm.covs, cfg.ivector_dim,
                          cfg.formulation, cfg.prior_offset)
    state = TrainState(model=model, ubm=ubm)
    n_iters = n_iters or cfg.n_iters

    prev: Optional[EN.UBMStats] = None
    start = 0
    mgr = None
    if ckpt_dir is not None:
        mgr = CM.CheckpointManager(ckpt_dir, save_interval=ckpt_interval,
                                   keep=ckpt_keep, device=dev)
        if mgr.has_checkpoint():
            # the newest verified checkpoint: a torn or tampered latest
            # write falls back instead of resuming from garbage
            tree, step, _ = mgr.restore_latest_verified(
                _ckpt_tree(state, None))
            state.model = tree["model"]
            state.ubm = tree["ubm"]
            zero = torch.zeros((), dtype=f32, device=dev)
            prev = EN.UBMStats(tree["n"], tree["f"], tree["ss"], zero, zero)
            start = min(int(step), n_iters)
            state.iteration = start

    def save(totals):
        if mgr is not None:
            mgr.maybe_save(state.iteration, _ckpt_tree(state, totals),
                           extra={"iteration": state.iteration})

    # When realignment can never fire the UBM is static: align once and
    # reuse the statistics; the streamed per-iteration pass runs only
    # when a write-back can change the alignments.
    if (cfg.realign_interval > 0 and cfg.ubm_update != "none"
            and cfg.formulation == "augmented"):
        for it in range(start, n_iters):
            if _realign_due(cfg, it, state.model):
                state.ubm = refresh_ubm(cfg, state.model, state.ubm, prev)
            state.model, prev, diag = iteration(cfg, state.model,
                                                state.ubm, feats, mask)
            state.iteration = it + 1
            save(prev)
            if callback is not None:
                callback(state, diag)
        return state

    st, (ll, frames) = stats_ll(cfg, state.ubm, feats, mask)
    avg_ll = ll / torch.clamp(frames, min=1.0)
    for it in range(start, n_iters):
        state.model, diag = em_iter(cfg, state.model, st.n, st.f, st.S)
        state.iteration = it + 1
        save(None)
        if callback is not None:
            callback(state, {**diag, "avg_loglik": avg_ll})
    return state


class _StepFeed:
    """Step-indexed feed for `fault_tolerance.run_supervised`: the batch
    is the (already device-resident) full macro-batch every step, so the
    data cursor is just the step counter: deterministic, resumable.
    ``gain`` is a float leaf the chaos NaN-batch injector can poison; the
    step multiplies the features by it (exactly 1.0 normally, so the
    product is bitwise the features)."""

    def __init__(self):
        self.step = 0

    def next(self):
        b = {"it": np.asarray(self.step, np.int64),
             "gain": np.asarray(1.0, np.float32)}
        self.step += 1
        return b

    def state(self):
        return {"step": self.step}

    def restore(self, st):
        self.step = int(st.get("step", 0))


def train_supervised(cfg: IVectorConfig, ubm: U.FullGMM, feats,
                     n_iters: Optional[int] = None,
                     generator: Optional[torch.Generator] = None, mask=None,
                     ckpt_dir=None, ckpt_keep: int = 3,
                     ckpt_keep_every: int = 0, mesh=None,
                     fail_at=None, max_restarts: Optional[int] = None,
                     policy: Optional[FT.RetryPolicy] = None,
                     guardrail=None, chaos: Optional[FT.Chaos] = None,
                     device=None):
    """Elastic training: the same macro-step as `train` with realignment
    (one fused streamed EM pass + the realignment write-back), driven by
    `distributed/fault_tolerance.run_supervised` with a checkpoint every
    macro-step. An `InjectedFailure` (``fail_at(step, attempt)``) lands in
    the worst-case window, after a step and before its checkpoint, so a
    failure costs exactly that macro-step and the restart resumes
    bit-exactly from the previous one (f32 npz round-trips exactly;
    alignment is a pure function of the restored model and UBM).

    The resilience policy comes from ``cfg`` unless overridden: ``policy``
    defaults to the config's restart/backoff/deadline knobs, ``guardrail``
    to `core.guardrails.make_guardrail` when ``cfg.guardrail`` is set, and
    the safety-ladder escalation (``cfg.escalate_after`` consecutive
    rollbacks at one step -> the next `guardrails.escalation_ladder`
    config) swaps the step in place. ``chaos`` injects drill faults.

    T is drawn once from ``generator`` as `train` draws it (a CPU
    generator seeded 0 when none is given), and every restart from
    scratch starts from that draw. ``mesh`` other than None raises: the
    port runs on one device. Returns (TrainState, SupervisorReport).
    """
    if ckpt_dir is None:
        raise ValueError("train_supervised requires ckpt_dir")
    if mesh is not None:
        raise NotImplementedError(
            f"mesh={mesh!r}: the port runs on one device; the mesh waits "
            "for ROADMAP Queue 1 item 11")
    dev = resolve_device(device)
    feats = torch.as_tensor(feats).to(dev, f32)
    mask = None if mask is None else torch.as_tensor(mask).to(dev)
    generator = (generator if generator is not None
                 else torch.Generator().manual_seed(0))
    ubm = ubm.to(dev)
    n_steps = n_iters or cfg.n_iters
    init_tree = {}

    def init_state_fn():
        # drawn once: a generator advances with every draw, and a restart
        # from scratch must see the same T
        if not init_tree:
            model = TV.init_model(generator, ubm.means, ubm.covs,
                                  cfg.ivector_dim, cfg.formulation,
                                  cfg.prior_offset)
            init_tree.update(_ckpt_tree(TrainState(model=model, ubm=ubm),
                                        None))
        return dict(init_tree)

    def make_step_fn(c: IVectorConfig):
        def step_fn(tree, batch):
            it = int(batch["it"])
            model, gmm = tree["model"], tree["ubm"]
            zero = torch.zeros((), dtype=f32, device=dev)
            prev = EN.UBMStats(tree["n"], tree["f"], tree["ss"], zero, zero)
            if _realign_due(c, it, model):
                gmm = refresh_ubm(c, model, gmm, prev)
            # gain is exactly 1.0 outside chaos drills: x * 1.0 is
            # bit-exact, and a poisoned (NaN) gain floods the features so
            # the guardrail trips on the resulting state
            model, tot, diag = iteration(c, model, gmm,
                                         feats * batch["gain"], mask)
            return _ckpt_tree(TrainState(model=model, ubm=gmm), tot), diag

        return step_fn

    if policy is None:
        policy = FT.RetryPolicy(
            max_restarts=(cfg.max_restarts if max_restarts is None
                          else max_restarts),
            backoff=cfg.retry_backoff, step_deadline=cfg.step_deadline,
            escalate_after=cfg.escalate_after)
    if guardrail is None and cfg.guardrail:
        guardrail = GR.make_guardrail(GR.GuardrailConfig(
            loglik_drop_tol=cfg.guardrail_loglik_drop))

    ladder = iter(GR.escalation_ladder(cfg))

    def on_escalate():
        c2 = next(ladder, None)
        return None if c2 is None else make_step_fn(c2)

    ckpt = CM.CheckpointManager(ckpt_dir, save_interval=1, keep=ckpt_keep,
                                keep_every=ckpt_keep_every, device=dev)
    report = FT.run_supervised(
        init_state_fn=init_state_fn, train_step_fn=make_step_fn(cfg),
        data_factory=_StepFeed, n_steps=n_steps, ckpt=ckpt,
        fail_at=fail_at, policy=policy, guardrail=guardrail,
        on_escalate=on_escalate, chaos=chaos, device=dev)
    tree, _, _ = ckpt.restore_latest_verified(init_state_fn())
    state = TrainState(model=tree["model"], ubm=tree["ubm"],
                       iteration=report.final_step)
    return state, report


def extract(cfg: IVectorConfig, state: TrainState, feats, mask=None,
            device=None) -> torch.Tensor:
    """i-vectors [U, R] for [U, F, D] features with the trained model and
    UBM (``mask`` [U, F] marks valid frames). The statistics pass skips
    the second moment, which extraction does not use."""
    dev = resolve_device(device)
    feats = torch.as_tensor(feats).to(dev, f32)
    mask = None if mask is None else torch.as_tensor(mask).to(dev)
    st, _ = stats_ll(cfg, state.ubm.to(dev), feats, mask,
                     second_order=False)
    model = state.model.to(dev)
    if model.formulation == "standard":
        stc = ST.center(ST.BWStats(st.n, st.f, None), model.means)
        n_, f_ = stc.n, stc.f
    else:
        n_, f_ = st.n, st.f
    pre = TV.precompute(model, estep=cfg.estep, device=dev)
    return TV.extract_ivectors(model, pre, n_, f_,
                               estep_dtype=cfg.estep_dtype)
