"""The PyTorch port's staged recipe, bundle and checkpoint API
(``repro_torch/api``, ``repro_torch/checkpoint``, ``core/pipeline.py``) against
the JAX package's, on the CPU.

Sizes are those of ``tests/test_api.py``; the features come from the JAX
``build_dataset`` as numpy, the UBM from the port's ``train_ubm`` on them,
and both packages get the same numpy arrays.

* **The §4.1 chain, end to end.** A JAX-trained state (2 iterations) is
  carried across with ``convert``; the port's ``pipeline.evaluate_state``
  EER equals JAX's ``evaluate_state`` within ``EER_TOL`` = 5e-4, five
  trials of the 10,000 in a class (measured: equal, for all six rescore x
  estep combinations), and the trial scores agree within ``SCORE_TOL`` =
  1e-4 x max|score| (measured: at most 5.6e-6; the i-vectors differ by up
  to 1.5e-5 of their largest entry, f32 statistics summed in another
  order).
* **Bundles.** A port bundle extracts bitwise as the in-memory session; the
  JAX package loads it and its content hash verifies; the port loads a JAX
  bundle with an equal content hash and serves i-vectors within
  ``IVEC_TOL`` = 1e-5 of the JAX ``from_bundle`` session (the serving
  tolerance of ``tests/test_torch_serving.py``).
* **Checkpoints.** Key strings equal the JAX package's; a resumed run is
  bitwise an uninterrupted one; a JAX trainer checkpoint restores bitwise;
  a corrupted newest step is skipped.
* **Recipe.** ``recipe.run`` on the (feats, labels, ubm) triple gives the
  same EER as ``evaluate_state`` on the same trained state; the stage
  registry and variant grid mirror ``tests/test_api.py``.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.api as JAPI  # noqa: E402
from repro.api import artifacts as JAR  # noqa: E402
from repro.api import bundle as JBU  # noqa: E402
from repro.checkpoint import manager as JCM  # noqa: E402
from repro.configs.ivector_tvm import SMOKE as J_SMOKE  # noqa: E402
from repro.core import pipeline as JPL  # noqa: E402
from repro.core import trainer as JTR  # noqa: E402
from repro.core import ubm as JU  # noqa: E402
from repro.data.speech import SpeechDataConfig, build_dataset  # noqa: E402
from repro.serving import IVectorExtractor as JEx  # noqa: E402
from repro.serving import ServingConfig as JSC  # noqa: E402

import repro_torch.api as TAPI  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import artifacts as TAR  # noqa: E402
from repro_torch.api import bundle as TBU  # noqa: E402
from repro_torch.checkpoint import manager as TCM  # noqa: E402
from repro_torch.configs.ivector_tvm import SMOKE as T_SMOKE  # noqa: E402
from repro_torch.core import pipeline as TPL  # noqa: E402
from repro_torch.core import trainer as TTR  # noqa: E402
from repro_torch.core import ubm as TU  # noqa: E402
from repro_torch.data.speech import make_trials  # noqa: E402
from repro_torch.serving import IVectorExtractor as TEx  # noqa: E402
from repro_torch.serving import ServingConfig as TSC  # noqa: E402

OVER = dict(feat_dim=8, n_components=16, ivector_dim=12, posterior_top_k=8,
            lda_dim=8, n_iters=2)
DATA = SpeechDataConfig(feat_dim=8, n_components=8, n_speakers=12,
                        utts_per_speaker=6, frames_per_utt=50,
                        speaker_rank=6, channel_rank=3,
                        speaker_scale=0.8, channel_scale=0.8)
SEED = 0
EER_TOL = 5e-4
SCORE_TOL = 1e-4
IVEC_TOL = 1e-5
LENGTHS = [50, 33, 17]


def _cfgs(**kw):
    return (J_SMOKE.with_overrides(**OVER, **kw),
            T_SMOKE.with_overrides(**OVER, **kw))


def _np(leaves):
    return tuple(np.asarray(a) for a in leaves)


@pytest.fixture(scope="module")
def data():
    """(feats [72, 50, 8] numpy from the JAX generator, labels, the UBM's
    (weights, means, covs) as numpy, trained by the port)."""
    feats, labels = build_dataset(DATA)
    feats = np.array(feats)
    ubm = TU.train_ubm(feats.reshape(-1, feats.shape[-1]),
                       OVER["n_components"], torch.Generator().manual_seed(0),
                       device="cpu")
    return feats, labels, _np((ubm.weights, ubm.means, ubm.covs))


def _jubm(ubm_np):
    return JU.FullGMM(*(jnp.asarray(a) for a in ubm_np))


def _tubm(ubm_np):
    return convert.ubm_from_numpy(*ubm_np, device="cpu")


def _port_state(jstate):
    m = jstate.model
    return TTR.TrainState(
        model=convert.tvm_from_numpy(*_np((m.T, m.Sigma, m.prior, m.means)),
                                     m.formulation, device="cpu"),
        ubm=convert.ubm_from_numpy(*_np((jstate.ubm.weights,
                                         jstate.ubm.means,
                                         jstate.ubm.covs)), device="cpu"),
        iteration=jstate.iteration)


@pytest.fixture(scope="module")
def jax_train(data):
    """cfg -> the JAX package's state after 2 iterations (cached)."""
    feats, _, ubm_np = data
    cache = {}

    def train(jcfg):
        if jcfg not in cache:
            cache[jcfg] = JTR.train(jcfg, _jubm(ubm_np), feats, n_iters=2,
                                    key=jax.random.PRNGKey(SEED + 100))
        return cache[jcfg]
    return train


@pytest.fixture(scope="module")
def port_run(data, tmp_path_factory):
    """One port recipe run on the (feats, labels, ubm) triple, with its
    bundle saved."""
    feats, labels, ubm_np = data
    _, tcfg = _cfgs()
    path = tmp_path_factory.mktemp("port") / "bundle"
    return TAPI.IVectorRecipe.from_config(tcfg, device="cpu").run(
        data=(feats, labels, _tubm(ubm_np)), seed=SEED, n_iters=2,
        bundle_dir=path)


def _utts(feats):
    return [feats[i, :n] for i, n in enumerate(LENGTHS)]


def _serving(cls):
    return cls(max_batch=2, min_bucket=16)


# ---------------------------------------------------------------------------
# The §4.1 chain on carried-across JAX states
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("estep", ["dense", "packed"])
@pytest.mark.parametrize("rescore", ["dense", "sparse", "fused"])
def test_eer_parity_on_carried_state(data, jax_train, rescore, estep):
    feats, labels, _ = data
    jcfg, tcfg = _cfgs(rescore=rescore, estep=estep)
    jstate = jax_train(jcfg)
    tstate = _port_state(jstate)
    want = JPL.evaluate_state(jcfg, jstate, feats, labels, SEED)
    got = TPL.evaluate_state(tcfg, tstate, feats, labels, SEED,
                             device="cpu")
    assert abs(got - want) <= EER_TOL, (got, want)
    assert 0.0 <= got <= 0.5
    # the trial scores themselves (LDA column signs do not reach them)
    a, b, _ = make_trials(labels, np.arange(len(labels)),
                          np.random.default_rng(SEED))
    jiv = JTR.extract(jcfg, jstate, feats)
    jart = JAR.train_backend(jcfg, jiv, labels)
    jsc = JAR.score_trials(jart, np.asarray(JAR.apply_backend(jart, jiv)),
                           a, b)
    tiv = TTR.extract(tcfg, tstate, feats, device="cpu")
    tart = TAR.train_backend(tcfg, tiv, labels)
    tsc = TAR.score_trials(tart, TAR.apply_backend(tart, tiv), a, b)
    err = np.abs(tsc - jsc).max()
    assert err <= SCORE_TOL * np.abs(jsc).max(), err


# ---------------------------------------------------------------------------
# Bundles, both ways
# ---------------------------------------------------------------------------


def test_bundle_roundtrip_bitwise_extraction(data, port_run):
    feats, _, _ = data
    _, tcfg = _cfgs()
    r = port_run
    assert r.bundle_path is not None
    utts = _utts(feats)
    mem = TEx.from_state(tcfg, (r.tv.model, r.tv.ubm), _serving(TSC),
                         device="cpu").extract(utts)
    loaded = TEx.from_bundle(r.bundle_path, _serving(TSC), device="cpu")
    np.testing.assert_array_equal(loaded.extract(utts), mem)
    assert loaded.cfg == tcfg
    assert loaded.bundle.provenance["seed"] == SEED
    assert "torch_version" in loaded.bundle.provenance
    b = loaded.bundle
    for got, want in ((b.backend.lda.proj, r.backend.lda.proj),
                      (b.backend.plda.B, r.backend.plda.B),
                      (b.backend.mu, r.backend.mu)):
        assert torch.equal(got, want)
    assert TBU.content_hash(b._tree()) == TBU.peek(
        r.bundle_path)["content_hash"]


def _port_bundle(port_run, labels, whitened: bool):
    """The port run's bundle, with a whitened backend when asked (the
    chain without min-divergence)."""
    r = port_run
    _, tcfg = _cfgs(min_divergence=not whitened)
    backend = TAR.train_backend(tcfg, torch.from_numpy(r.ivectors), labels)
    assert (backend.whitener is not None) == whitened
    return TBU.Bundle(cfg=tcfg, ubm=r.tv.ubm, model=r.tv.model,
                      backend=backend, provenance=dict(r.provenance))


@pytest.mark.parametrize("whitened", [False, True])
def test_jax_loads_port_bundle(data, port_run, tmp_path, whitened):
    feats, labels, _ = data
    bundle = _port_bundle(port_run, labels, whitened)
    path = bundle.save(tmp_path / "b")
    jb = JBU.Bundle.load(path)      # verifies the content hash
    assert JBU.content_hash(jb._tree()) == TBU.content_hash(bundle._tree())
    assert (jb.backend.whitener is not None) == whitened
    np.testing.assert_array_equal(np.asarray(jb.model.T),
                                  bundle.model.T.numpy())
    np.testing.assert_array_equal(np.asarray(jb.backend.plda.W),
                                  bundle.backend.plda.W.numpy())
    assert jb.model.formulation == bundle.model.formulation
    if whitened:    # the backend does not reach extraction
        return
    utts = _utts(feats)
    want = JEx.from_bundle(path, _serving(JSC)).extract(utts)
    got = TEx.from_bundle(path, _serving(TSC), device="cpu").extract(utts)
    np.testing.assert_allclose(got, want, rtol=0, atol=IVEC_TOL)


@pytest.mark.parametrize("whitened", [False, True])
def test_port_loads_jax_bundle(data, jax_train, tmp_path, whitened):
    feats, labels, _ = data
    jcfg, tcfg = _cfgs()
    jstate = jax_train(jcfg)
    jiv = JTR.extract(jcfg, jstate, feats)
    jback = JAR.train_backend(jcfg.with_overrides(
        min_divergence=not whitened), jiv, labels)
    path = JBU.Bundle(cfg=jcfg, ubm=jstate.ubm, model=jstate.model,
                      backend=jback, provenance={"seed": SEED}).save(
                          tmp_path / "jb")
    tb = TBU.Bundle.load(path, device="cpu")
    assert tb.cfg == tcfg
    assert TBU.content_hash(tb._tree()) == JBU.peek(path)["content_hash"]
    want_back = convert.backend_from_numpy(
        *_np((jback.mu, jback.lda.mean, jback.lda.proj, jback.plda.mean,
              jback.plda.B, jback.plda.W)),
        whitener=None if jback.whitener is None else np.asarray(
            jback.whitener), device="cpu")
    for got, want in ((tb.backend.mu, want_back.mu),
                      (tb.backend.lda.proj, want_back.lda.proj),
                      (tb.backend.plda.B, want_back.plda.B)):
        assert torch.equal(got, want)
    assert (tb.backend.whitener is not None) == whitened
    if whitened:
        assert torch.equal(tb.backend.whitener, want_back.whitener)
        return      # the backend does not reach extraction
    utts = _utts(feats)
    want = JEx.from_bundle(path, _serving(JSC)).extract(utts)
    got = TEx.from_bundle(path, _serving(TSC), device="cpu").extract(utts)
    np.testing.assert_allclose(got, want, rtol=0, atol=IVEC_TOL)


def test_bundle_schema_version_gating(port_run, tmp_path):
    path = port_run.bundle_path
    mf = Path(path) / "step_00000000" / "manifest.json"
    manifest = json.loads(mf.read_text())
    try:
        manifest["extra"]["schema_version"] = TAPI.SCHEMA_VERSION + 1
        mf.write_text(json.dumps(manifest))
        with pytest.raises(ValueError, match="schema_version"):
            TBU.Bundle.load(path, device="cpu")
        manifest["extra"]["kind"] = "something-else"
        mf.write_text(json.dumps(manifest))
        with pytest.raises(ValueError, match="not an i-vector bundle"):
            TBU.Bundle.load(path, device="cpu")
    finally:
        manifest["extra"].update(schema_version=TAPI.SCHEMA_VERSION,
                                 kind="ivector-bundle")
        mf.write_text(json.dumps(manifest))


def test_bundle_integrity_check(port_run):
    path = port_run.bundle_path
    mf = Path(path) / "step_00000000" / "manifest.json"
    manifest = json.loads(mf.read_text())
    want = manifest["extra"]["content_hash"]
    try:
        manifest["extra"]["content_hash"] = "0" * 64
        mf.write_text(json.dumps(manifest))
        with pytest.raises(ValueError, match="integrity"):
            TBU.Bundle.load(path, device="cpu")
        assert TBU.Bundle.load(path, verify=False, device="cpu") is not None
    finally:
        manifest["extra"]["content_hash"] = want
        mf.write_text(json.dumps(manifest))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def test_flatten_keys_match_jax(port_run, data):
    _, labels, _ = data
    bundle = _port_bundle(port_run, labels, whitened=True)
    jskel = JBU._skeleton(J_SMOKE, {"formulation": "augmented",
                                    "has_backend": True,
                                    "has_whitener": True})
    assert set(TCM.flatten(bundle._tree())) == set(JCM._flatten(jskel))
    r = port_run
    st = TTR.TrainState(r.tv.model, r.tv.ubm, 2)
    z = jnp.zeros(())
    jst = JTR.TrainState(model=jskel["model"], ubm=JU.FullGMM(
        jnp.zeros(2), jnp.zeros((2, 3)), z))
    assert set(TCM.flatten(TTR._ckpt_tree(st, None))) == set(
        JCM._flatten(JTR._ckpt_tree(jst, None)))


def _state_tensors(state):
    m, u = state.model, state.ubm
    return (m.T, m.Sigma, m.prior, m.means, u.weights, u.means, u.covs)


def _assert_states_equal(a, b):
    assert a.iteration == b.iteration
    for x, y in zip(_state_tensors(a), _state_tensors(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("over", [
    {}, dict(rescore="fused", realign_interval=1, ubm_update="full")],
    ids=["statistics-once", "realign-full"])
def test_resume_is_bitwise_uninterrupted(data, tmp_path, over):
    feats, _, ubm_np = data
    _, tcfg = _cfgs(**over)

    def run(n, ckpt_dir=None):
        return TTR.train(tcfg, _tubm(ubm_np), feats, n_iters=n,
                         generator=torch.Generator().manual_seed(7),
                         ckpt_dir=ckpt_dir, device="cpu")
    whole = run(3)
    TTR.train(tcfg, _tubm(ubm_np), feats, n_iters=1,
              generator=torch.Generator().manual_seed(7),
              ckpt_dir=tmp_path, device="cpu")
    assert TCM.all_steps(tmp_path) == [1]
    _assert_states_equal(run(3, tmp_path), whole)
    assert TCM.all_steps(tmp_path) == [1, 2, 3]


def test_jax_trainer_checkpoint_restores(data, tmp_path):
    feats, _, ubm_np = data
    jcfg, _ = _cfgs(rescore="fused", realign_interval=1, ubm_update="full")
    jstate = JTR.train(jcfg, _jubm(ubm_np), feats, n_iters=1,
                       key=jax.random.PRNGKey(3), ckpt_dir=tmp_path)
    want = _port_state(jstate)
    tree, step, extra = TCM.restore(tmp_path, TTR._ckpt_tree(want, None),
                                    device="cpu")
    assert step == 1 and extra == {"iteration": 1}
    got = TTR.TrainState(tree["model"], tree["ubm"], step)
    _assert_states_equal(got, want)
    assert tree["model"].formulation == "augmented"
    # the streamed totals of the last pass travel with it
    assert tree["n"].shape == (OVER["n_components"],)
    assert float(tree["n"].sum()) == pytest.approx(feats.shape[0]
                                                   * feats.shape[1], rel=1e-5)


def test_corrupt_newest_step_is_skipped(data, tmp_path):
    feats, _, ubm_np = data
    _, tcfg = _cfgs()

    def run(n, ckpt_dir=None):
        return TTR.train(tcfg, _tubm(ubm_np), feats, n_iters=n,
                         generator=torch.Generator().manual_seed(9),
                         ckpt_dir=ckpt_dir, device="cpu")
    whole = run(2)
    run(2, tmp_path)
    npz = tmp_path / "step_00000002" / "arrays.npz"
    raw = bytearray(npz.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    npz.write_bytes(bytes(raw))
    with pytest.raises(TCM.CheckpointCorruption, match="sha256"):
        TCM.verify(tmp_path, 2)
    assert TCM.latest_verified_step(tmp_path) == 1
    (tmp_path / ".tmp_dead").mkdir()
    assert TCM.clean_stale_tmp(tmp_path) == [".tmp_dead"]
    mgr = TCM.CheckpointManager(tmp_path, device="cpu")
    skel = TTR._ckpt_tree(whole, None)
    _, step, _ = mgr.restore_latest_verified(skel)
    assert step == 1 and mgr.skipped_corrupt == [2]
    with pytest.raises(TCM.CheckpointCorruption):
        mgr.restore_latest(skel)
    # the trainer resumes from step 1 and lands on the same state
    _assert_states_equal(run(2, tmp_path), whole)


def test_checkpoint_bf16_roundtrip(tmp_path):
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    tree = {"a": x.to(torch.bfloat16), "b": x}
    TCM.save(tmp_path, 4, tree)
    manifest = TCM.verify(tmp_path, 4)
    assert manifest["keys"]["a"]["dtype"] == "bfloat16"
    got, step, _ = TCM.restore(tmp_path, tree, device="cpu")
    assert step == 4 and got["a"].dtype == torch.bfloat16
    assert torch.equal(got["a"], tree["a"]) and torch.equal(got["b"], x)


def test_refusals(data, tmp_path):
    feats, labels, ubm_np = data
    _, tcfg = _cfgs()
    recipe = TAPI.IVectorRecipe.from_config(tcfg, device="cpu")
    triple = (feats, labels, _tubm(ubm_np))
    # the supervisor is ported; like the JAX stage it needs a ckpt_dir
    with pytest.raises(ValueError, match="requires ckpt_dir"):
        recipe.run(data=triple, n_iters=1, supervised=True)
    # a one-rank mesh, as an argument or in the config, runs and equals
    # the meshless run
    plain = recipe.run(data=triple, n_iters=1)
    for got in (recipe.run(data=triple, n_iters=1, mesh=(1, 1)),
                TAPI.IVectorRecipe.from_config(
                    tcfg.with_overrides(mesh=(1, 1)), device="cpu").run(
                        data=triple, n_iters=1)):
        assert got.eer == plain.eer
        np.testing.assert_array_equal(got.ivectors, plain.ivectors)
        assert got.provenance["mesh"] == [["data", 1], ["model", 1]]
    # the elastic re-mesh knobs are no refusals now: a save stores the
    # axes, and rules of one rank (or none) restore the whole tensors
    ck = tmp_path / "elastic"
    tree = {"p": {"w": torch.arange(6.0).reshape(2, 3)}}
    TCM.CheckpointManager(ck, logical_axes={"p": {"w": ("batch", None)}}
                          ).maybe_save(1, tree, force=True)
    assert TCM.verify(ck, 1)["axes"] == {"p|w": ["batch", None]}
    got, _, _ = TCM.restore(ck, tree, rules=None, device="cpu")
    assert torch.equal(got["p"]["w"], tree["p"]["w"])


# ---------------------------------------------------------------------------
# Recipe, stages, variants
# ---------------------------------------------------------------------------


def test_api_exports_match_jax():
    assert TAPI.__all__ == JAPI.__all__


def test_recipe_run_matches_evaluate_state(data, port_run):
    feats, labels, ubm_np = data
    _, tcfg = _cfgs()
    state = TTR.train(tcfg, _tubm(ubm_np), feats, n_iters=2,
                      generator=torch.Generator().manual_seed(SEED + 100),
                      device="cpu")
    want = TPL.evaluate_state(tcfg, state, feats, labels, SEED,
                              device="cpu")
    r = port_run
    assert r.eer == want
    assert torch.equal(r.tv.model.T, state.model.T)
    assert r.tv.iterations == 2 and r.ubm.n_components == 16
    assert r.ivectors.shape == (len(labels), OVER["ivector_dim"])
    prov = r.provenance
    assert prov["schema_version"] == TAPI.SCHEMA_VERSION
    assert prov["mesh"] == [["data", 1], ["model", 1]]
    assert prov["resilience"]["supervised"] is False
    assert set(prov["resilience"]["policy"]) == {
        "max_restarts", "backoff", "backoff_cap", "jitter", "step_deadline",
        "escalate_after", "retryable"}


def test_recipe_curve_and_shim(data):
    feats, labels, ubm_np = data
    _, tcfg = _cfgs()
    ubm = _tubm(ubm_np)
    legacy = TPL.run_variant(tcfg, feats, labels, ubm, n_iters=2,
                             eval_every=1, seed=1, device="cpu")
    r = TAPI.IVectorRecipe.from_config(tcfg, device="cpu").run(
        data=(feats, labels, ubm), seed=1, n_iters=2, eval_every=1)
    assert [it for it, _ in legacy["curve"]] == [1, 2]
    assert legacy["curve"] == r.curve
    assert r.eer == r.curve[-1][1]


def test_recipe_ensemble_matches_shim(data, tmp_path):
    feats, labels, ubm_np = data
    _, tcfg = _cfgs()
    ubm = _tubm(ubm_np)
    legacy = TPL.run_ensemble(tcfg, None, [0, 1], n_iters=1, eval_every=1,
                              name="legacy", out_dir=tmp_path, feats=feats,
                              labels=labels, ubm=ubm, device="cpu")
    r = TAPI.IVectorRecipe.from_config(tcfg, name="new",
                                       device="cpu").ensemble(
        data=(feats, labels, ubm), seeds=[0, 1], n_iters=1)
    assert legacy["iters"] == r["iters"] == [1]
    assert legacy["eer_mean"] == r["eer_mean"]
    assert (tmp_path / "legacy.json").exists()


def test_recipe_from_data_config(tmp_path):
    """The whole chain from a data config: features and UBM stages too."""
    _, tcfg = _cfgs()
    r = TAPI.IVectorRecipe.from_config(tcfg, DATA, device="cpu").run(
        seed=0, n_iters=1, bundle_dir=tmp_path / "b")
    assert np.isfinite(r.eer) and 0.0 <= r.eer <= 0.5
    assert r.ubm.meta["n_frames"] == 72 * 50
    assert TBU.peek(r.bundle_path)["provenance"]["stages"] == list(
        TAPI.IVectorRecipe.DEFAULT_STAGES)


def test_canonical_stages_registered():
    for name in TAPI.IVectorRecipe.DEFAULT_STAGES:
        assert name in TAPI.STAGE_REGISTRY, name


def test_custom_stage_composes(data):
    feats, labels, ubm_np = data
    _, tcfg = _cfgs()
    calls = []

    @TAPI.register_stage
    class ProbeStage:
        name = "probe-test-stage"

        def run(self, ctx):
            calls.append(ctx.tv.iterations)
            ctx.metrics["probed"] = 1.0
            return ctx

    try:
        recipe = TAPI.IVectorRecipe.from_config(
            tcfg, stages=("features", "ubm", "tvm", "probe-test-stage",
                          "backend", "eval"), device="cpu")
        r = recipe.run(data=(feats, labels, _tubm(ubm_np)), seed=0,
                       n_iters=1)
        assert calls == [1]
        assert r.metrics["probed"] == 1.0
        assert np.isfinite(r.eer)
    finally:
        TAPI.STAGE_REGISTRY.pop("probe-test-stage", None)


def test_unknown_stage_rejected():
    _, tcfg = _cfgs()
    with pytest.raises(KeyError, match="unknown stage"):
        TAPI.IVectorRecipe.from_config(tcfg, stages=("features", "nope"),
                                       device="cpu")


def test_variant_grid_one_result_per_combination(data):
    feats, labels, ubm_np = data
    _, tcfg = _cfgs()
    recipe = TAPI.IVectorRecipe.from_config(tcfg, device="cpu")
    grid = dict(formulation=["standard", "augmented"],
                estep=["dense", "packed"])
    assert len(recipe.variants(**grid)) == 4
    out = recipe.run_variants(data=(feats, labels, _tubm(ubm_np)), seed=0,
                              n_iters=1, **grid)
    assert len(out) == 4
    variants = [tuple(sorted(r.provenance["variant"].items()))
                for r in out.values()]
    assert len(set(variants)) == 4
    for name, r in out.items():
        assert np.isfinite(r.eer) and 0.0 <= r.eer <= 0.6
        assert r.provenance["recipe"] == name
        ov = r.provenance["variant"]
        assert r.cfg.formulation == ov["formulation"]
        assert r.cfg.estep == ov["estep"]
