"""The TVM trainer (the port of ``repro/core/trainer.py``): the paper's
§3.2 training loop, with its variants switchable by the config:

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

Every entry point resolves a mesh (``mesh`` argument > ``cfg.mesh`` > the
default: one rank without a process group, the whole world with one,
``launch/mesh.py``) and runs every macro-step through the engine's mesh
mode, so ``ubm_update`` and realignment work the same on any number of
ranks. Every rank calls the entry point with the same global arrays;
``_place`` puts the rank's block of utterances on its device, and every
rank ends with the same model. ``macro_batch`` streams each pass through
``data.speech.prefetch_to_device`` in slices of each rank's block instead
of one resident block.

Long runs checkpoint through `checkpoint/manager.py` (``ckpt_dir``): model
+ UBM + last-pass sufficient statistics are saved every ``ckpt_interval``
iterations, in the JAX package's format (by rank 0 on a mesh), and
restored on restart. `train_supervised` wraps the same macro-step in
`distributed/fault_tolerance.run_supervised`: an injected failure costs
exactly one macro-step and the restart resumes bit-exactly from the last
checkpoint.

Entry points run on ``device`` (CUDA unless the caller names another; on
a mesh of several ranks, the mesh's device). A kernel failure during
training raises: the trainer has no demotion ladder.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import manager as CM
from repro_torch.configs.ivector_tvm import IVectorConfig
from repro_torch.core import engine as EN
from repro_torch.core import guardrails as GR
from repro_torch.core import stats as ST
from repro_torch.core import tvm as TV
from repro_torch.core import ubm as U
from repro_torch.data import speech as DS
from repro_torch.distributed import fault_tolerance as FT
from repro_torch.launch import mesh as MS

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


def _resolve_mesh(cfg: IVectorConfig, mesh, n_utts: int,
                  device=None) -> MS.Mesh:
    """The trainer-side mesh default: explicit argument > ``cfg.mesh`` >
    the default mesh (``launch.mesh.resolve_mesh``), built on ``device``.
    An explicit ``Mesh`` keeps its own device."""
    return MS.resolve_mesh(mesh if mesh is not None else cfg.mesh,
                           n_utts=n_utts, n_components=cfg.n_components,
                           device=device)


def _place(mesh: MS.Mesh, feats, mask):
    """This rank's block of the utterances (and mask) on its device, once
    per call site, so that the iterations never move features again."""
    feats = MS.data_block(mesh, torch.as_tensor(feats)).to(f32)
    mask = (None if mask is None
            else MS.data_block(mesh, torch.as_tensor(mask)))
    return feats, mask


def stats_ll(cfg: IVectorConfig, ubm: U.FullGMM, feats, mask=None,
             second_order: Optional[bool] = None,
             mesh: Optional[MS.Mesh] = None):
    """feats [U, F, D] -> (BWStats, (loglik, frames)) through the engine
    (the body of the JAX ``make_stats_ll_fn``; with ``second_order=False``
    that of ``make_stats_fn``). S is tracked when the config updates Σ.
    On a ``mesh`` ``feats``/``mask`` are the rank's block (``_place``) and
    the per-utterance n/f come back whole, in rank order."""
    so = cfg.update_sigma if second_order is None else second_order
    return EN.stream_bw(_spec(cfg, so), EN.pack_ubm(ubm, feats.device),
                        feats, mask, mesh=mesh)


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


def _track_S(cfg: IVectorConfig) -> bool:
    return cfg.update_sigma or cfg.ubm_update == "full"


def iteration(cfg: IVectorConfig, model: TV.TVModel, ubm: U.FullGMM, feats,
              mask=None, mesh: Optional[MS.Mesh] = None):
    """One fused streamed EM iteration (the body of the JAX
    ``make_iter_fn``) -> (new model, totals, diagnostics): the engine feeds
    the global sufficient statistics (``TotalsAccum``: the Σ update and
    the UBM refresh) and the TVM E-step (``TVMAccum``) from one pass. On a
    ``mesh`` (``feats``/``mask`` the rank's block) the pass runs in the
    engine's mesh mode and the M-step on the exit-reduced accumulators,
    the same on every rank."""
    spec = _spec(cfg, _track_S(cfg))
    pack = EN.pack_ubm(ubm, feats.device)
    accums = _iter_accums(cfg, spec, model, feats.shape[-1])
    (tot, acc), _ = EN.stream(spec, pack, feats, mask, accums, mesh=mesh)
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
          ckpt_keep: int = 3, mesh=None, macro_batch: int = 0,
          prefetch: int = 2, device=None) -> TrainState:
    """The training loop on in-memory features [U, F, D] (``mask`` [U, F]
    marks valid frames, so ragged batches train exactly).

    T is initialised from ``generator`` (a CPU generator seeded 0 when
    none is given, so a run is reproducible on any device and every rank
    draws the same T). ``callback`` gets (state, diagnostics) after every
    iteration. With ``ckpt_dir`` the loop saves model + UBM + last-pass
    statistics every ``ckpt_interval`` iterations (keeping ``ckpt_keep``)
    and resumes from the newest checkpoint that verifies: the trajectory
    is bitwise that of an uninterrupted run on the same device.

    ``mesh``: a ``launch.mesh.Mesh``, a ``(data, model)`` tuple, or None
    (``cfg.mesh``, else the default mesh). Every rank passes the same
    arguments. A one-rank mesh is the local path bit for bit; a data-only
    mesh with ``cfg.estep_chunk`` = U / data extent reproduces it bit for
    bit (the ordered exit fold), other meshes up to f32 reassociation.
    ``macro_batch`` > 0 streams each pass through
    ``data.speech.prefetch_to_device`` (``prefetch`` batches in flight) in
    slices of ``macro_batch`` / data extent utterances of each rank's own
    block, merged on the rank and reduced once a pass: with
    ``estep_chunk`` equal to that slice the pass is bitwise the resident
    one. (The reference slices the global batch and reduces every slice.)
    """
    mesh = _resolve_mesh(cfg, mesh, feats.shape[0], device)
    dev = mesh.device
    generator = (generator if generator is not None
                 # repro-check: disable=SRC002
                 else torch.Generator().manual_seed(0))
    ubm = ubm.to(dev)
    model = TV.init_model(generator, ubm.means, ubm.covs, cfg.ivector_dim,
                          cfg.formulation, cfg.prior_offset)
    state = TrainState(model=model, ubm=ubm)
    n_iters = n_iters or cfg.n_iters
    batched = bool(macro_batch) and 0 < macro_batch < feats.shape[0]
    if batched:
        if macro_batch % mesh.data_extent:
            raise ValueError(f"macro_batch={macro_batch} does not divide "
                             f"the mesh's data extent {mesh.data_extent}")
        # the rank's block stays where the caller keeps it; slices of it
        # are copied to the device as they are streamed
        feats = MS.data_block(mesh, torch.as_tensor(feats), device=False)
        mask = (None if mask is None else
                MS.data_block(mesh, torch.as_tensor(mask), device=False))
    else:
        feats, mask = _place(mesh, feats, mask)

    prev: Optional[EN.UBMStats] = None
    start = 0
    mgr = None
    if ckpt_dir is not None:
        mgr = CM.CheckpointManager(ckpt_dir, save_interval=ckpt_interval,
                                   keep=ckpt_keep, device=dev, mesh=mesh)
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

    realign_possible = (cfg.realign_interval > 0
                        and cfg.ubm_update != "none"
                        and cfg.formulation == "augmented")
    if batched:
        spec = _spec(cfg, _track_S(cfg))
        for it in range(start, n_iters):
            if realign_possible and _realign_due(cfg, it, state.model):
                state.ubm = refresh_ubm(cfg, state.model, state.ubm, prev)
            pack = EN.pack_ubm(state.ubm, dev)
            accums = _iter_accums(cfg, spec, state.model, feats.shape[-1])
            parts = None
            for fb, mb in DS.prefetch_to_device(
                    DS.iter_batches(feats, mask,
                                    macro_batch // mesh.data_extent),
                    size=prefetch, device=dev):
                p, _ = EN.stream_partial(spec, pack, fb.to(f32), mb, accums,
                                         mesh=mesh)
                parts = p if parts is None else (
                    merge_totals(parts[0], p[0]),
                    TV.merge_accums(parts[1], p[1]))
            tot, acc = EN.reduce_partials(mesh, accums, parts)
            state.model, diag = _finish_iteration(cfg, state.model, tot,
                                                  acc)
            prev = tot
            state.iteration = it + 1
            save(prev)
            if callback is not None:
                callback(state, diag)
        return state

    # When realignment can never fire the UBM is static: align once and
    # reuse the statistics; the streamed per-iteration pass runs only
    # when a write-back can change the alignments.
    if realign_possible:
        for it in range(start, n_iters):
            if _realign_due(cfg, it, state.model):
                state.ubm = refresh_ubm(cfg, state.model, state.ubm, prev)
            state.model, prev, diag = iteration(cfg, state.model,
                                                state.ubm, feats, mask,
                                                mesh=mesh)
            state.iteration = it + 1
            save(prev)
            if callback is not None:
                callback(state, diag)
        return state

    st, (ll, frames) = stats_ll(cfg, state.ubm, feats, mask, mesh=mesh)
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
    scratch starts from that draw. ``mesh`` as in `train`: every rank
    runs the supervisor, rank 0 writes the checkpoints and every rank
    restores them, so a restart happens on every rank at once. Returns
    (TrainState, SupervisorReport).
    """
    if ckpt_dir is None:
        raise ValueError("train_supervised requires ckpt_dir")
    mesh = _resolve_mesh(cfg, mesh, feats.shape[0], device)
    dev = mesh.device
    feats, mask = _place(mesh, feats, mask)
    generator = (generator if generator is not None
                 # repro-check: disable=SRC002
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
                                         feats * batch["gain"], mask,
                                         mesh=mesh)
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
                                keep_every=ckpt_keep_every, device=dev,
                                mesh=mesh)
    report = FT.run_supervised(
        init_state_fn=init_state_fn, train_step_fn=make_step_fn(cfg),
        data_factory=_StepFeed, n_steps=n_steps, ckpt=ckpt,
        fail_at=fail_at, policy=policy, guardrail=guardrail,
        on_escalate=on_escalate, chaos=chaos, device=dev, mesh=mesh)
    tree, _, _ = ckpt.restore_latest_verified(init_state_fn())
    state = TrainState(model=tree["model"], ubm=tree["ubm"],
                       iteration=report.final_step)
    return state, report


def extract(cfg: IVectorConfig, state: TrainState, feats, mask=None,
            mesh=None, device=None) -> torch.Tensor:
    """i-vectors [U, R] for [U, F, D] features with the trained model and
    UBM (``mask`` [U, F] marks valid frames). The statistics pass skips
    the second moment, which extraction does not use. ``mesh`` shards the
    statistics pass as in `train` (per-utterance n/f are bitwise the same
    on every mesh); every rank then solves for all the i-vectors."""
    mesh = _resolve_mesh(cfg, mesh, feats.shape[0], device)
    dev = mesh.device
    feats, mask = _place(mesh, feats, mask)
    st, _ = stats_ll(cfg, state.ubm.to(dev), feats, mask,
                     second_order=False, mesh=mesh)
    model = state.model.to(dev)
    if model.formulation == "standard":
        stc = ST.center(ST.BWStats(st.n, st.f, None), model.means)
        n_, f_ = stc.n, stc.f
    else:
        n_, f_ = st.n, st.f
    pre = TV.precompute(model, estep=cfg.estep, device=dev)
    return TV.extract_ivectors(model, pre, n_, f_,
                               estep_dtype=cfg.estep_dtype)
