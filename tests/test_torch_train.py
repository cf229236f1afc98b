"""Parity of the PyTorch port's training paths with the JAX package, on the
CPU: the i-vector trainer (``ubm.train_ubm``, ``trainer.train`` in both of
its branches, ``trainer.extract``), then LM training (the second half of
this file: the token pipeline, AdamW, the chunked loss, ``loss_fn``,
``make_train_step``, the supervised launcher and LM train checkpoints; its
tolerances are stated there).

Both packages start from the same initial values: the port's random
initialisations (``ubm.init_diag_from_data``, ``tvm.init_model``) draw from
a ``torch.Generator``, the JAX package's from a JAX key, so the tests hand
the JAX draws to the port through ``monkeypatch``. The JAX trainer runs on
a one-device mesh, its jnp path (the Pallas bf16 interpret path is a known
reference failure).

What is compared. ``min_divergence`` diagonalises with ``eigh``, whose
eigenvectors are defined up to sign, so the two trained models may differ
by a rotation of T's columns 2..R that the E-step and M-step carry along
unchanged. The tests compare what that rotation leaves alone: T_c T_c^T,
``updated_ubm_means`` (T[:, :, 0] p), the prior's norm, Sigma, the UBM,
the per-iteration diagnostics and the Gram matrix of the extracted
i-vectors, each to 2e-3 x its largest |value| (f32 statistics summed in
another order, through three EM iterations of solves and Cholesky
factors), 1e-2 with bf16 E-step inputs. ``extract`` on the same model is
compared directly, to 1e-4.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.ivector_tvm import SMOKE as J_SMOKE  # noqa: E402
from repro.core import trainer as JTR  # noqa: E402
from repro.core import tvm as JTV  # noqa: E402
from repro.core import ubm as JU  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.ivector_tvm import SMOKE as T_SMOKE  # noqa: E402
from repro_torch.core import trainer as TTR  # noqa: E402
from repro_torch.core import tvm as TTV  # noqa: E402
from repro_torch.core import ubm as TU  # noqa: E402

C, D, R, K = 8, 5, 6, 4
U_, F = 18, 24
TOL = 2e-3
# bf16 E-step inputs: an f32 rounding difference upstream (the two packages'
# precompute) can flip the bf16 rounding of an input, one bf16 ulp = 2^-8
# relative, and three iterations carry it on
BF16_TOL = 1e-2
KEY = jax.random.PRNGKey(4)


def _close_rel(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-12), err


@pytest.fixture(scope="module")
def data():
    """A UBM and 18 utterances x 24 frames drawn from it, each utterance
    with its own offset (a stand-in for speaker and channel)."""
    rng = np.random.default_rng(0)
    means = (2.0 * rng.standard_normal((C, D))).astype(np.float32)
    A = (0.3 * rng.standard_normal((C, D, D))).astype(np.float32)
    covs = (np.einsum("cij,ckj->cik", A, A)
            + 0.5 * np.eye(D, dtype=np.float32)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, C).astype(np.float32)
    w /= w.sum()
    comp = rng.choice(C, size=(U_, F), p=w)
    chol = np.linalg.cholesky(covs)
    z = rng.standard_normal((U_, F, D, 1))
    shift = 0.7 * rng.standard_normal((U_, 1, D))
    x = means[comp] + (chol[comp] @ z)[..., 0] + shift
    return (w, means, covs), x.astype(np.float32)


def _jax_ubm(ubm):
    return JU.FullGMM(*(jnp.asarray(a) for a in ubm))


def _port_model_from(jm):
    return convert.tvm_from_numpy(
        *(np.asarray(a) for a in (jm.T, jm.Sigma, jm.prior, jm.means)),
        jm.formulation, device="cpu")


def _inject_init_model(monkeypatch, cfg, jubm):
    """The JAX ``train`` draws T from ``KEY``; the port gets that draw."""
    jm0 = JTV.init_model(KEY, jubm.means, jubm.covs, cfg.ivector_dim,
                         cfg.formulation, cfg.prior_offset)
    monkeypatch.setattr(TTV, "init_model",
                        lambda *a, **k: _port_model_from(jm0))


def _model_invariants(model, ubm):
    T = np.asarray(model.T, np.float64)
    prior = np.asarray(model.prior, np.float64)
    return {"TTt": np.einsum("cdr,cer->cde", T, T),
            "mean_col": T[:, :, 0] * prior[0],
            "prior_norm": np.linalg.norm(prior),
            "Sigma": np.asarray(model.Sigma),
            "ubm_weights": np.asarray(ubm.weights),
            "ubm_means": np.asarray(ubm.means),
            "ubm_covs": np.asarray(ubm.covs)}


def _gram(iv):
    iv = np.asarray(iv, np.float64)
    return iv @ iv.T


def _cfgs(**kw):
    over = dict(feat_dim=D, n_components=C, ivector_dim=R,
                posterior_top_k=K, estep_chunk=4, prior_offset=10.0, **kw)
    return J_SMOKE.with_overrides(**over), T_SMOKE.with_overrides(**over)


@pytest.mark.parametrize("over,tol", [
    (dict(formulation="augmented", estep="packed", rescore="sparse"), TOL),
    (dict(formulation="standard", estep="dense", rescore="dense"), TOL),
    (dict(formulation="augmented", estep="packed", rescore="fused",
          realign_interval=1, ubm_update="full"), TOL),
    (dict(formulation="augmented", ubm_update="means", realign_interval=2),
     TOL),
    (dict(formulation="augmented", estep="packed", rescore="sparse",
          estep_dtype="bfloat16"), BF16_TOL),
], ids=["augmented-packed-sparse", "standard-dense-dense",
        "fused-realign1-full", "realign2-means", "bf16"])
def test_train_matches_jax_on_invariants(monkeypatch, data, over, tol):
    """Three EM iterations; 18 utterances in chunks of 4 leave a remainder
    chunk of 2 in every E-step pass."""
    ubm, x = data
    jcfg, tcfg = _cfgs(**over)
    jubm = _jax_ubm(ubm)
    _inject_init_model(monkeypatch, jcfg, jubm)
    jdiag, tdiag = [], []
    jst = JTR.train(jcfg, jubm, jnp.asarray(x), n_iters=3, key=KEY,
                    mesh=(1, 1),
                    callback=lambda s, d: jdiag.append(
                        {k: float(v) for k, v in d.items()}))
    tst = TTR.train(tcfg, convert.ubm_from_numpy(*ubm, device="cpu"), x,
                    n_iters=3, device="cpu",
                    callback=lambda s, d: tdiag.append(
                        {k: float(v) for k, v in d.items()}))
    assert tst.iteration == jst.iteration == 3
    got = _model_invariants(tst.model, tst.ubm)
    want = _model_invariants(jst.model, jst.ubm)
    for name in want:
        assert np.isfinite(got[name]).all(), name
        _close_rel(got[name], want[name], tol)
    assert [sorted(d) for d in tdiag] == [sorted(d) for d in jdiag]
    for td, jd in zip(tdiag, jdiag):
        for k in jd:
            _close_rel(td[k], jd[k], tol)
    if over.get("realign_interval"):
        # the write-back changed the UBM the frames are aligned with
        assert not np.allclose(got["ubm_means"], ubm[1])
    tiv = TTR.extract(tcfg, tst, x, device="cpu")
    jiv = JTR.extract(jcfg, jst, jnp.asarray(x), mesh=(1, 1))
    _close_rel(_gram(tiv), _gram(jiv), tol)


@pytest.mark.parametrize("formulation,rescore", [
    ("augmented", "fused"), ("standard", "sparse")])
def test_extract_matches_jax_on_the_same_model(data, formulation, rescore):
    """``extract`` with one model in both packages: no rotation to factor
    out, the i-vectors themselves agree. A ragged mask pads utterances."""
    ubm, x = data
    jcfg, tcfg = _cfgs(formulation=formulation, rescore=rescore)
    jubm = _jax_ubm(ubm)
    jm = JTV.init_model(KEY, jubm.means, jubm.covs, R, formulation, 10.0)
    mask = np.ones((U_, F), np.float32)
    mask[::3, F - 7:] = 0.0
    jiv = JTR.extract(jcfg, JTR.TrainState(jm, jubm), jnp.asarray(x),
                      mask=jnp.asarray(mask), mesh=(1, 1))
    tst = TTR.TrainState(_port_model_from(jm),
                         convert.ubm_from_numpy(*ubm, device="cpu"))
    tiv = TTR.extract(tcfg, tst, x, mask=mask, device="cpu")
    assert tiv.shape == (U_, R)
    np.testing.assert_allclose(tiv.numpy(), np.asarray(jiv), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("flat,top_k,rescore", [
    (True, K, "sparse"), (False, 0, "dense"), (True, K, "fused")])
def test_train_ubm_matches_jax(monkeypatch, data, flat, top_k, rescore):
    """Diag then full EM from the same initial diag UBM, on flat frames
    (re-chunked into 50-frame pseudo-utterances, the last one padded and
    masked) or on the utterances with a mask; ``top_k=0`` keeps all C."""
    _, x = data
    if flat:
        xj, mask, kw = x.reshape(-1, D)[:-10], None, dict(frame_chunk=50)
    else:
        mask = np.ones((U_, F), np.float32)
        mask[1::4, F - 5:] = 0.0
        xj, kw = x, {}
    feats, m = JU._as_utterances(jnp.asarray(xj), None if mask is None
                                 else jnp.asarray(mask),
                                 kw.get("frame_chunk", 4096))
    key = jax.random.PRNGKey(7)
    init = JU.init_diag_from_data(feats, C, key, mask=m)
    monkeypatch.setattr(TU, "init_diag_from_data",
                        lambda *a, **k: convert.diag_from_numpy(
                            *(np.asarray(v) for v in (init.weights,
                                                      init.means,
                                                      init.vars)),
                            device="cpu"))
    args = dict(diag_iters=3, full_iters=2, top_k=top_k, chunk=3,
                rescore=rescore, **kw)
    want = JU.train_ubm(jnp.asarray(xj), C, key,
                        mask=None if mask is None else jnp.asarray(mask),
                        **args)
    got = TU.train_ubm(xj, C, torch.Generator().manual_seed(0), mask=mask,
                       device="cpu", **args)
    for g, w in zip((got.weights, got.means, got.covs),
                    (want.weights, want.means, want.covs)):
        _close_rel(g, w)
    assert torch.linalg.eigvalsh(got.covs).min() > 0


def test_merge_totals_and_refresh_ubm_match_jax(data):
    """``refresh_ubm`` from one pass's totals ('full': weights, means and
    PSD-floored covariances) and ``merge_totals`` of two passes."""
    ubm, x = data
    jcfg, tcfg = _cfgs(formulation="augmented", realign_interval=1,
                       ubm_update="full")
    jubm = _jax_ubm(ubm)
    jm = JTV.init_model(KEY, jubm.means, jubm.covs, R, "augmented", 10.0)
    jm2, jtot, _ = JTR.make_iter_fn(jcfg)(jm, jubm, jnp.asarray(x))
    tubm = convert.ubm_from_numpy(*ubm, device="cpu")
    tm2, ttot, _ = TTR.iteration(tcfg, _port_model_from(jm), tubm,
                                 torch.from_numpy(x))
    for g, w in zip(ttot, jtot):
        _close_rel(g, w, 1e-4)
    # refresh both from the same (JAX) model and totals
    tm2 = _port_model_from(jm2)
    ttot = type(ttot)(*(torch.from_numpy(np.array(a)) for a in jtot))
    jnew = JTR.refresh_ubm(jcfg, jm2, jubm, jtot)
    tnew = TTR.refresh_ubm(tcfg, tm2, tubm, ttot)
    for g, w in zip((tnew.weights, tnew.means, tnew.covs),
                    (jnew.weights, jnew.means, jnew.covs)):
        _close_rel(g, w, 1e-4)
    means_only = TTR.refresh_ubm(tcfg, tm2, tubm, ttot,
                                 update_weights=False, update_covs=False)
    assert torch.equal(means_only.covs, tubm.covs)
    doubled = TTR.merge_totals(ttot, ttot)
    assert torch.equal(doubled.n, 2 * ttot.n)
    assert TTR._realign_due(tcfg, 1, tm2) and not TTR._realign_due(
        tcfg, 0, tm2)


def test_training_entry_points_default_to_cuda(monkeypatch, data):
    """No card and no explicit device: ``train``, ``train_ubm`` and
    ``extract`` raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ubm, x = data
    _, tcfg = _cfgs(formulation="augmented")
    tubm = convert.ubm_from_numpy(*ubm, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTR.train(tcfg, tubm, x, n_iters=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TU.train_ubm(x, C, torch.Generator().manual_seed(0))
    state = TTR.TrainState(
        TTV.init_model(torch.Generator().manual_seed(0), tubm.means,
                       tubm.covs, R, "augmented"), tubm)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTR.extract(tcfg, state, x)


# ---------------------------------------------------------------------------
# LM training: repro_torch.{data.tokens, optim, models.api, launch.train}
# ---------------------------------------------------------------------------
#
# Inputs come from numpy seeds and the JAX pipeline (bitwise the port's);
# JAX-drawn train states are carried across with
# ``convert.lm_state_from_numpy``. Tolerances:
#   * LM_TOL (1e-5 x max|value|): the same f32 function of the same inputs,
#     summed in another order: the loss, and every param leaf's gradient
#     through two (StableLM) or eight (Jamba) SMOKE layers, where the JAX
#     attention is blockwise and its scan chunked-associative, the port's
#     plain and sequential (read: 2e-6);
#   * OPT_TOL (1e-6 relative): one AdamW update of the same f32 inputs (f32
#     pow, sqrt and divisions, fused differently by XLA and torch);
#   * after train steps, params within ADAM_R * 2 * sum_t lr_t: at steps 1
#     and 2 an update's direction m^/(sqrt(v^) + eps) has |.| <= 1.0004
#     (ADAM_R; Cauchy-Schwarz on the moments' weights, b1 = 0.9, b2 = 0.95),
#     so an element whose gradient is ~0 in both packages may move by up to
#     that much in opposite directions; the moments, which carry the
#     gradients, are held to LM_TOL.

from repro.checkpoint import restore as j_restore  # noqa: E402
from repro.checkpoint import save as j_save  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data.tokens import TokenPipeline as JPipe  # noqa: E402
from repro.data.tokens import TokenPipelineConfig as JPipeCfg  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint import CheckpointManager as TCkpt  # noqa: E402
from repro_torch.checkpoint import restore as t_restore  # noqa: E402
from repro_torch.checkpoint import save as t_save  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline as TPipe  # noqa: E402
from repro_torch.data.tokens import TokenPipelineConfig as TPipeCfg  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    run_supervised)
from repro_torch.kernels import flash_attention as TFA  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402
from repro_torch.kernels import selective_scan as TSS  # noqa: E402
from repro_torch.launch import train as TLAUNCH  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.optim import AdamWConfig as TAdamW  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

LM_TOL = 1e-5
# gradients through the experts: the f32 sums of the router's softmax and
# the expert products' backward, as tests/test_torch_moe.py holds them
MOE_GRAD_TOL = 1e-4
OPT_TOL = 1e-6
ADAM_R = 1.0004
STABLELM, JAMBA = "stablelm-1.6b", "jamba-v0.1-52b"
LM_SEQ, LM_BATCH = 32, 4


def _lm_cfgs(arch, experts=False, **kw):
    """The f32 SMOKE config of ``arch`` in both packages, without experts
    unless asked."""
    jc, tc = j_get_config(arch, smoke=True), t_get_config(arch, smoke=True)
    if jc.moe is not None and not experts:
        kw = {"moe": None, **kw}
    return jc.with_overrides(**kw), tc.with_overrides(**kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _lm_close(got, want, tol=LM_TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), err


def _batches(vocab, n, seq=LM_SEQ, batch=LM_BATCH, **kw):
    pipe = JPipe(JPipeCfg(vocab_size=vocab, seq_len=seq, global_batch=batch,
                          **kw))
    return [pipe.next() for _ in range(n)]


def _t_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def lm_jax_states():
    """arch -> the JAX init_state (numpy) of its f32 SMOKE config."""
    out = {}
    for i, arch in enumerate((STABLELM, JAMBA)):
        jc, _ = _lm_cfgs(arch)
        out[arch] = _np_tree(japi.init_state(jc, jax.random.PRNGKey(10 + i)))
    jc, _ = _lm_cfgs(JAMBA, experts=True)
    out[JAMBA, True] = _np_tree(japi.init_state(jc, jax.random.PRNGKey(12)))
    return out


@pytest.mark.parametrize("seed,step,shard,n_shards,kw", [
    (0, 0, 0, 1, {}),
    (3, 17, 1, 2, {"noise": 0.2, "active_vocab": 64}),
    (7, 5, 3, 4, {"noise": 0.0}),
])
def test_token_pipeline_bitwise_jax(seed, step, shard, n_shards, kw):
    jcfg = JPipeCfg(vocab_size=97, seq_len=32, global_batch=8, seed=seed,
                    **kw)
    tcfg = TPipeCfg(vocab_size=97, seq_len=32, global_batch=8, seed=seed,
                    **kw)
    jb = JPipe(jcfg, shard, n_shards).batch_at(step)
    tb = TPipe(tcfg, shard, n_shards).batch_at(step)
    for k in ("tokens", "labels"):
        assert tb[k].dtype == jb[k].dtype
        np.testing.assert_array_equal(tb[k], jb[k])


def test_token_pipeline_deterministic_and_resumable():
    """The port of tests/test_substrate.py's pipeline test."""
    cfg = TPipeCfg(vocab_size=97, seq_len=32, global_batch=8)
    p1 = TPipe(cfg)
    batches = [p1.next() for _ in range(5)]
    p2 = TPipe(cfg)
    p2.restore({"step": 2})
    np.testing.assert_array_equal(p2.next()["tokens"], batches[2]["tokens"])
    assert p2.state() == {"step": 3}
    pa, pb = TPipe(cfg, shard=0, n_shards=2), TPipe(cfg, shard=1, n_shards=2)
    assert pa.next()["tokens"].shape[0] == 4
    assert not np.array_equal(pa.batch_at(0)["tokens"],
                              pb.batch_at(0)["tokens"])
    b = batches[0]
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_schedule_and_global_norm_match_jax():
    oc_j, oc_t = JAdamW(), TAdamW()
    steps = np.array([0, 1, 2, 50, 100, 101, 5000, 9999, 10000, 20000],
                     np.int32)
    for s in steps:
        want = float(jadamw._schedule(oc_j, jnp.asarray(s)))
        got = float(tadamw._schedule(oc_t, torch.tensor(int(s),
                                                        dtype=torch.int32)))
        assert abs(got - want) <= OPT_TOL * max(abs(want), 1e-12), (s, got,
                                                                    want)
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b/c": rng.standard_normal((7,)).astype(np.float32),
            "z": rng.standard_normal((2, 2, 2)).astype(np.float32)}
    want = float(jadamw.global_norm({k: jnp.asarray(v)
                                     for k, v in tree.items()}))
    got = float(tadamw.global_norm({k: torch.as_tensor(v)
                                    for k, v in tree.items()}))
    assert abs(got - want) <= OPT_TOL * want


@pytest.mark.parametrize("pdtype,mdtype,count", [
    ("float32", "float32", 0), ("float32", "float32", 150),
    ("bfloat16", "bfloat16", 3)])
def test_adamw_update_matches_jax(pdtype, mdtype, count):
    """One update from the same params, grads and moments. bf16 params and
    moments are held to one bf16 ulp (2^-7 relative): their f32 values
    agree to OPT_TOL, and the cast may round either side of a tie."""
    rng = np.random.default_rng(count)
    shapes = {"embed": (16, 8), "layer/w": (2, 8, 4), "s": (8,)}
    p = {k: 0.02 * rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    g["s"][:3] = 0.0
    m = {k: 0.1 * rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: 0.01 * rng.random(s).astype(np.float32)
         for k, s in shapes.items()}
    jdt, tdt = jnp.dtype(pdtype), getattr(torch, pdtype)
    jm, tm = jnp.dtype(mdtype), getattr(torch, mdtype)
    oc_j = JAdamW(moment_dtype=mdtype)
    oc_t = TAdamW(moment_dtype=mdtype)
    jp, jo, jmet = jadamw.adamw_update(
        {k: jnp.asarray(a).astype(jdt) for k, a in p.items()},
        {k: jnp.asarray(a).astype(jdt) for k, a in g.items()},
        {"m": {k: jnp.asarray(a).astype(jm) for k, a in m.items()},
         "v": {k: jnp.asarray(a).astype(jm) for k, a in v.items()},
         "count": jnp.asarray(count, jnp.int32)}, oc_j)
    tp, to, tmet = tadamw.adamw_update(
        {k: torch.as_tensor(a).to(tdt) for k, a in p.items()},
        {k: torch.as_tensor(a).to(tdt) for k, a in g.items()},
        {"m": {k: torch.as_tensor(a).to(tm) for k, a in m.items()},
         "v": {k: torch.as_tensor(a).to(tm) for k, a in v.items()},
         "count": torch.tensor(count, dtype=torch.int32)}, oc_t)
    assert int(to["count"]) == int(jo["count"]) == count + 1
    assert to["count"].dtype == torch.int32
    for k in ("grad_norm", "lr"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= OPT_TOL * abs(
            float(jmet[k]))
    tol = 2.0 ** -7 if pdtype == "bfloat16" else OPT_TOL
    for got, want in [(tp[k], jp[k]) for k in shapes] + [
            (to[w][k], jo[w][k]) for w in ("m", "v") for k in shapes]:
        assert got.dtype == getattr(torch, str(want.dtype))
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol * np.abs(want).max())


@pytest.mark.parametrize("with_mask", [False, True])
def test_softmax_xent_matches_jax(with_mask):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((2, 5, 33))).astype(np.float32)
    labels = rng.integers(0, 33, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32) if with_mask \
        else None
    want = JL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                           None if mask is None else jnp.asarray(mask))
    got = TL.softmax_xent(torch.as_tensor(logits), torch.as_tensor(labels),
                          None if mask is None else torch.as_tensor(mask))
    _lm_close(got, want)


@pytest.mark.parametrize("S,chunk,vocab,tie,with_mask", [
    (64, 32, 500, False, True),     # two chunks; vocab padded 500 -> 512
    (48, 32, 512, False, False),    # 48 % 32: the single-chunk fallback
    (32, 512, 300, True, True),     # chunk > S; tied embeddings, padded
])
def test_chunked_lm_loss_and_grads_match_jax(S, chunk, vocab, tie,
                                             with_mask):
    jc, tc = _lm_cfgs(STABLELM, vocab_size=vocab, tie_embeddings=tie)
    rng = np.random.default_rng(S + vocab)
    B, D, Vp = 2, jc.d_model, TL.padded_vocab(vocab)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = 0.05 * rng.standard_normal((Vp, D) if tie else (D, Vp)
                                   ).astype(np.float32)
    name = "embed" if tie else "unembed"
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32) if with_mask \
        else None

    def jloss(xx, ww):
        return JL.chunked_lm_loss(jc, {name: ww}, xx, jnp.asarray(labels),
                                  None if mask is None else jnp.asarray(mask),
                                  chunk=chunk)
    jl, (jgx, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    tl = TL.chunked_lm_loss(tc, {name: tw}, tx, torch.as_tensor(labels),
                            None if mask is None else torch.as_tensor(mask),
                            chunk=chunk)
    gx, gw = torch.autograd.grad(tl, (tx, tw))
    _lm_close(tl, jl)
    _lm_close(gx, jgx)
    _lm_close(gw, jgw)


WITH_EXPERTS = [pytest.param(STABLELM, False, id=STABLELM),
                pytest.param(JAMBA, False, id=JAMBA),
                pytest.param(JAMBA, True, id=JAMBA + "-experts")]


def _state_key(arch, experts):
    return (arch, True) if experts else arch


@pytest.mark.parametrize("arch,experts", WITH_EXPERTS)
def test_loss_and_grads_match_jax(lm_jax_states, arch, experts):
    """``loss_fn`` and the gradient of every param leaf against
    ``jax.value_and_grad`` of the JAX ``loss_fn``, from the same state and
    batch; Jamba with its experts too (the router aux loss included),
    its gradients within 1e-4 of each leaf's largest |value|, as
    ``tests/test_torch_moe.py`` holds them."""
    jc, tc = _lm_cfgs(arch, experts)
    params = lm_jax_states[_state_key(arch, experts)]["params"]
    batch = _batches(jc.vocab_size, 1)[0]
    jl, jg = jax.value_and_grad(lambda p, b: japi.loss_fn(jc, p, b))(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in batch.items()})
    tp = convert.lm_params_from_numpy(params, "float32", "cpu")
    names = sorted(tp)
    leaves = [tp[k].requires_grad_() for k in names]
    tl = tapi.loss_fn(tc, dict(zip(names, leaves)), _t_batch(batch))
    tg = torch.autograd.grad(tl, leaves)
    _lm_close(tl, jl)
    assert set(names) == set(jg)
    for k, g in zip(names, tg):
        _lm_close(g, jg[k], MOE_GRAD_TOL if experts else LM_TOL)


@pytest.mark.parametrize("arch,accum,experts", [
    pytest.param(STABLELM, 1, False, id=STABLELM + "-1"),
    pytest.param(JAMBA, 1, False, id=JAMBA + "-1"),
    pytest.param(STABLELM, 2, False, id=STABLELM + "-2"),
    pytest.param(JAMBA, 2, True, id=JAMBA + "-experts-2")])
def test_two_train_steps_match_jax(lm_jax_states, arch, accum, experts):
    """Two ``make_train_step`` steps (default AdamW) from the same state and
    batches: losses, grad norms and lr to LM_TOL, the moments to LM_TOL
    (MOE_GRAD_TOL with experts), the params within the sign-flip bound
    (module comment)."""
    jc, tc = _lm_cfgs(arch, experts, grad_accum=accum)
    state = lm_jax_states[_state_key(arch, experts)]
    tol = MOE_GRAD_TOL if experts else LM_TOL
    jstep = jax.jit(japi.make_train_step(jc))
    tstep = tapi.make_train_step(tc)
    js = jax.tree.map(jnp.asarray, state)
    ts = convert.lm_state_from_numpy(state, "float32", "cpu")
    lrs = []
    for b in _batches(jc.vocab_size, 2):
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, _t_batch(b))
        for k in ("loss", "grad_norm", "lr"):
            _lm_close(tm[k], jm[k], tol)
        lrs.append(float(jm["lr"]))
    assert int(ts["opt"]["count"]) == int(js["opt"]["count"]) == 2
    bound = ADAM_R * 2 * sum(lrs)
    for k, p in ts["params"].items():
        want = np.asarray(js["params"][k])
        assert p.dtype == torch.float32 and p.shape == want.shape
        assert np.abs(p.numpy() - want).max() <= bound + 1e-7, k
        for w in ("m", "v"):
            _lm_close(ts["opt"][w][k], js["opt"][w][k], tol)


@pytest.mark.parametrize("arch", [STABLELM, JAMBA])
def test_remat_on_and_off_give_the_same_bits(lm_jax_states, arch):
    """Recomputing each layer (or period) in the backward pass changes
    what is kept, not what is computed: the loss and every gradient are
    bitwise the same with remat on and off."""
    grads = []
    for remat in ("layer", "nothing"):
        _, tc = _lm_cfgs(arch, remat=remat)
        tp = convert.lm_params_from_numpy(lm_jax_states[arch]["params"],
                                          "float32", "cpu")
        names = sorted(tp)
        leaves = [tp[k].requires_grad_() for k in names]
        loss = tapi.loss_fn(tc, dict(zip(names, leaves)),
                            _t_batch(_batches(tc.vocab_size, 1)[0]))
        grads.append([loss.detach()] + list(torch.autograd.grad(loss,
                                                                leaves)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,S,H,KVH,hd,block", [
    (2, 37, 4, 2, 16, 8), (1, 70, 6, 3, 32, 16), (1, 64, 2, 2, 16, 64),
    (1, 100, 4, 1, 256, 32), (2, 70, 4, 2, 256, 16)])
def test_attention_backward_blocks_match_autograd(B, S, H, KVH, hd, block):
    """``flash_attention.lse_blocks`` and ``backward_blocks`` (the forward's
    log-sum-exp and the backward kernels' tile walk, ragged S included)
    against autograd of the plain attention, to LM_TOL; at hd 256 under
    MQA and GQA, with the dK/dV pass's query heads in ``bwd_splits``
    partials added in split order."""
    rng = np.random.default_rng(S)
    q, k, v = (torch.tensor(rng.standard_normal((B, S, n, hd)).astype(
        np.float32), requires_grad=True) for n in (H, KVH, KVH))
    o = TREF.flash_attention(q, k, v)
    do = torch.as_tensor(rng.standard_normal(o.shape).astype(np.float32))
    want = torch.autograd.grad(o, (q, k, v), do)
    s = torch.einsum("bqhd,bkhd->bhqk", q.detach(),
                     k.detach().repeat_interleave(H // KVH, 2)) * hd ** -0.5
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    lse = TFA.lse_blocks(q.detach(), k.detach(), block)
    _lm_close(lse, torch.logsumexp(s, -1))
    got = TFA.backward_blocks(q.detach(), k.detach(), v.detach(),
                              o.detach(), lse, do, block)
    for a, b in zip(got, want):
        _lm_close(a, b)


# the bf16 backward's limit (chip_smoke.py's ATT_BWD_BF16_TOL): each
# gradient rounded once at its store, Delta formed from the forward's bf16 o
ATT_BWD_BF16_TOL = 2.0 ** -7


@pytest.mark.parametrize("B,S,H,KVH,hd,block", [
    (1, 70, 4, 2, 64, 16), (2, 33, 2, 1, 128, 32), (1, 100, 4, 1, 256, 32),
    (2, 70, 4, 2, 256, 16)])
def test_attention_backward_blocks_bf16_within_limit(B, S, H, KVH, hd,
                                                      block):
    """``backward_blocks`` on bf16 inputs (P and dS split into bf16 hi and
    lo before their products, as on the tensor cores; o the forward's bf16
    output; at hd 256 the dK/dV partials of ``bwd_splits``) against
    autograd of the plain attention in f32 on the same values: every
    gradient within 2^-7 of max|plain|."""
    rng = np.random.default_rng(S + hd)
    q, k, v, do = (torch.tensor(rng.standard_normal((B, S, n, hd)).astype(
        np.float32)).to(torch.bfloat16) for n in (H, KVH, KVH, H))
    ins = [t.float().requires_grad_() for t in (q, k, v)]
    out = TREF.flash_attention(*ins)
    want = torch.autograd.grad(out, ins, do.float())
    got = TFA.backward_blocks(q, k, v, out.detach().to(torch.bfloat16),
                              TFA.lse_blocks(q, k, block), do, block)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        _lm_close(a, w, ATT_BWD_BF16_TOL)


def test_attention_backward_blocks_hd256_match_jax_grad():
    """``backward_blocks`` at hd 256 under MQA (the hd-256 tensor-core
    kernels' algorithm: 4 query heads over 4 dK/dV splits) against
    ``jax.grad`` of the JAX package's ``blockwise_causal_attention`` on the
    same numpy inputs, in f32 on the CPU: every gradient within LM_TOL of
    max|JAX| (the same f32 function summed in another order), the
    log-sum-exps from ``lse_blocks`` and o from the plain forward."""
    B, S, H, KVH, hd = 1, 96, 4, 1, 256
    rng = np.random.default_rng(256)
    q, k, v, do = (rng.standard_normal((B, S, n, hd)).astype(np.float32)
                   for n in (H, KVH, KVH, H))
    assert TFA.bwd_splits(torch.bfloat16, B, S, H, KVH, hd) == 4
    _, vjp = jax.vjp(JL.blockwise_causal_attention, jnp.asarray(q),
                     jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.as_tensor(a) for a in (q, k, v, do))
    got = TFA.backward_blocks(tq, tk, tv, TREF.flash_attention(tq, tk, tv),
                              TFA.lse_blocks(tq, tk), tdo)
    for a, w in zip(got, want):
        _lm_close(a, w)


def test_bf16_split_holds_a_float_to_2_to_the_minus_16():
    """``split_bf16``: hi + lo holds each f32 value to about 2^-16 of it,
    where bf16 alone holds it to 2^-9."""
    x = torch.tensor(np.random.default_rng(5).standard_normal(4096).astype(
        np.float32)) * 3.0
    hi, lo = TFA.split_bf16(x)
    assert torch.equal(hi, x.to(torch.bfloat16).float())
    rel = ((hi + lo - x).abs() / x.abs()).max().item()
    assert rel <= 2.0 ** -16
    assert ((hi - x).abs() / x.abs()).max().item() > 2.0 ** -12


def _scan_backward_case(B, T, di, ds, with_h0, with_dh, **seg):
    """``backward_chunks`` against autograd of the plain scan, to LM_TOL,
    on inputs drawn from a seed."""
    rng = np.random.default_rng(T + seg.get("seg_chunks", 0))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    dt = torch.nn.functional.softplus(torch.as_tensor(f(B, T, di)) - 1)
    ins = [dt, torch.as_tensor(f(B, T, di)),
           -torch.exp(torch.as_tensor(f(di, ds))),
           torch.as_tensor(f(B, T, ds)), torch.as_tensor(f(B, T, ds))]
    if with_h0:
        ins.append(torch.as_tensor(f(B, di, ds)))
    ins = [t.requires_grad_() for t in ins]
    y, h_last = TREF.selective_scan(*ins[:5], ins[5] if with_h0 else None)
    dy = torch.as_tensor(f(B, T, di))
    dh = torch.as_tensor(f(B, di, ds)) if with_dh else None
    want = torch.autograd.grad([y] + ([h_last] if with_dh else []), ins,
                               [dy] + ([dh] if with_dh else []))
    got = TSS.backward_chunks(*(t.detach() for t in ins[:5]), dy,
                              ins[5].detach() if with_h0 else None, dh,
                              **seg)
    assert (got[5] is None) == (not with_h0)
    for a, b in zip(got, want):
        _lm_close(a, b)


@pytest.mark.parametrize("B,T,di,ds,with_h0,with_dh", [
    (2, 37, 5, 4, False, False), (1, 50, 3, 8, True, True),
    (1, 16, 4, 16, True, False)])
def test_scan_backward_chunks_match_autograd(B, T, di, ds, with_h0,
                                             with_dh):
    """``selective_scan.backward_chunks`` (the backward kernels' walk: chunk
    start states kept, chunks recomputed last to first; one segment at
    these T) against autograd of the plain scan, to LM_TOL."""
    _scan_backward_case(B, T, di, ds, with_h0, with_dh)


@pytest.mark.parametrize("B,T,di,ds,with_h0,with_dh,seg_chunks", [
    (2, 37, 5, 4, False, False, 1), (1, 50, 3, 8, True, True, 1),
    (1, 80, 4, 16, True, True, 2), (1, 64, 3, 32, False, True, 3),
    (2, 96, 2, 8, True, False, 2), (1, 48, 4, 16, False, False, 2)])
def test_scan_backward_segments_match_autograd(B, T, di, ds, with_h0,
                                               with_dh, seg_chunks):
    """``backward_chunks`` cut into segments of ``seg_chunks`` chunks (the
    adjoint of each segment from a zero carry, the carries composed last
    to first, the segments rerun from their carries), T a multiple of a
    segment or not, against autograd of the plain scan, to LM_TOL."""
    assert TSS.n_segments(T, seg_chunks) > 1
    _scan_backward_case(B, T, di, ds, with_h0, with_dh,
                        seg_chunks=seg_chunks)


def _sup_run(cfg, pipe_cfg, ckpt_dir, fail_at=None):
    step = tapi.make_train_step(cfg)
    init = lambda: tapi.init_state(  # noqa: E731
        cfg, torch.Generator().manual_seed(7), device="cpu")
    ck = TCkpt(ckpt_dir, save_interval=2, device="cpu")
    rep = run_supervised(init_state_fn=init, train_step_fn=step,
                         data_factory=lambda: TPipe(pipe_cfg), n_steps=6,
                         ckpt=ck, fail_at=fail_at, device="cpu")
    state, at, _ = ck.restore_latest(init())
    return rep, state, at


def test_restart_bitexact_after_failure(tmp_path):
    """The port of tests/test_substrate.py's test: training with a failure
    at step 4 and a restart from the step-4 checkpoint ends bitwise at the
    uninterrupted run's state."""
    _, cfg = _lm_cfgs(STABLELM)
    pipe_cfg = TPipeCfg(vocab_size=cfg.vocab_size, seq_len=32,
                        global_batch=4)
    state = tapi.init_state(cfg, torch.Generator().manual_seed(7),
                            device="cpu")
    step = tapi.make_train_step(cfg)
    pipe = TPipe(pipe_cfg)
    for _ in range(6):
        state, _ = step(state, _t_batch(pipe.next()))
    rep, got, at = _sup_run(cfg, pipe_cfg, tmp_path / "a",
                            fail_at=lambda s, a: s == 4 and a == 0)
    assert (rep.n_restarts, rep.final_step, at) == (1, 6, 6)
    for w in ("params", "m", "v"):
        ref_t = state["params"] if w == "params" else state["opt"][w]
        got_t = got["params"] if w == "params" else got["opt"][w]
        for k in ref_t:
            assert torch.equal(ref_t[k], got_t[k]), (w, k)


def test_lm_training_loss_decreases():
    """The port of tests/test_substrate.py's test: 30 steps of StableLM
    SMOKE on a learnable chain lower the loss by more than 0.5 nats."""
    _, cfg = _lm_cfgs(STABLELM)
    pipe = TPipe(TPipeCfg(vocab_size=cfg.vocab_size, seq_len=64,
                          global_batch=8, noise=0.2, active_vocab=64))
    state = tapi.init_state(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    step = tapi.make_train_step(cfg, TAdamW(lr=1e-3, warmup_steps=5))
    losses = []
    for _ in range(30):
        state, m = step(state, _t_batch(pipe.next()))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses[::6]


def test_train_main_runs_and_resumes(tmp_path, capsys):
    """``launch.train.main`` with the JAX flags plus --device: a run of 4
    steps, then the same command for 6 resumes at step 4 from its
    checkpoint and ends bitwise where an uninterrupted 6-step run ends."""
    base = ["--arch", STABLELM, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt-interval", "2", "--log-every", "2"]
    r1 = TLAUNCH.main(base + ["--steps", "4", "--ckpt-dir",
                              str(tmp_path / "a")])
    assert (r1["final_step"], len(r1["losses"])) == (4, 4)
    r2 = TLAUNCH.main(base + ["--steps", "6", "--ckpt-dir",
                              str(tmp_path / "a")])
    assert (r2["final_step"], r2["n_restarts"], len(r2["losses"])) == (6, 0,
                                                                       2)
    r3 = TLAUNCH.main(base + ["--steps", "6", "--ckpt-dir",
                              str(tmp_path / "b")])
    assert r3["losses"][4:] == r2["losses"]
    _, cfg = _lm_cfgs(STABLELM)
    like = tapi.init_state(t_get_config(STABLELM, smoke=True),
                           torch.Generator().manual_seed(0), device="cpu")
    a, _, _ = t_restore(tmp_path / "a", like, device="cpu")
    b, _, _ = t_restore(tmp_path / "b", like, device="cpu")
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k])
    r4 = TLAUNCH.main(base + ["--steps", "3"])   # no checkpoints
    assert len(r4["losses"]) == 3 and np.isfinite(r4["losses"]).all()
    assert "first loss" in capsys.readouterr().out


def test_train_main_refuses_what_the_port_lacks():
    """(Named while the launcher refused moe and ssm; the name is kept so
    that its record carries on.) The port lacks nothing the JAX launcher
    trains: Jamba with its experts trains through ``main``, the ssm family
    passes the check, and audio exits as in the JAX launcher."""
    out = TLAUNCH.main(["--arch", JAMBA, "--smoke", "--device", "cpu",
                        "--steps", "1", "--batch", "2", "--seq", "16"])
    assert out["final_step"] == 1 and np.isfinite(out["losses"]).all()
    cfg = t_get_config(STABLELM, smoke=True)
    TLAUNCH.check_trainable(cfg.with_overrides(family="ssm"))
    with pytest.raises(SystemExit):
        TLAUNCH.check_trainable(cfg.with_overrides(family="audio"))


def _bf16_cfgs():
    return _lm_cfgs(STABLELM, param_dtype="bfloat16")


def test_lm_train_checkpoint_port_to_jax(tmp_path):
    """A port save of ``init_state`` (bf16 params, f32 moments) restores in
    ``repro.checkpoint.restore`` with equal leaves and dtypes."""
    jc, tc = _bf16_cfgs()
    ts = tapi.init_state(tc, torch.Generator().manual_seed(1), device="cpu")
    ts["opt"]["count"] = torch.tensor(5, dtype=torch.int32)
    t_save(tmp_path, 5, ts, extra={"data": {"step": 5}})
    like = japi.init_state(jc, jax.random.PRNGKey(0))
    got, step, extra = j_restore(tmp_path, like)
    assert (step, extra) == (5, {"data": {"step": 5}})
    assert int(got["opt"]["count"]) == 5
    for k, p in ts["params"].items():
        assert got["params"][k].dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(got["params"][k], np.float32),
                                      p.float().numpy())
        for w in ("m", "v"):
            assert got["opt"][w][k].dtype == jnp.float32
            np.testing.assert_array_equal(np.asarray(got["opt"][w][k]),
                                          ts["opt"][w][k].numpy())


def test_lm_train_checkpoint_jax_to_port(tmp_path):
    """A JAX save of a train state after one step restores in the port's
    ``restore`` with equal leaves and dtypes (bf16 included)."""
    jc, tc = _bf16_cfgs()
    js = japi.init_state(jc, jax.random.PRNGKey(2))
    b = _batches(jc.vocab_size, 1)[0]
    js, _ = japi.make_train_step(jc)(js, {k: jnp.asarray(v)
                                          for k, v in b.items()})
    j_save(tmp_path, 1, js)
    like = tapi.init_state(tc, torch.Generator().manual_seed(0),
                           device="cpu")
    got, step, _ = t_restore(tmp_path, like, device="cpu")
    assert step == 1 and got["opt"]["count"].dtype == torch.int32
    assert int(got["opt"]["count"]) == 1
    for k in js["params"]:
        assert got["params"][k].dtype == torch.bfloat16
        np.testing.assert_array_equal(got["params"][k].float().numpy(),
                                      np.asarray(js["params"][k], np.float32))
        for w in ("m", "v"):
            np.testing.assert_array_equal(got["opt"][w][k].numpy(),
                                          np.asarray(js["opt"][w][k]))


@pytest.mark.parametrize("arch,experts", WITH_EXPERTS)
def test_state_struct_matches_jax(arch, experts):
    jc, tc = j_get_config(arch), t_get_config(arch)
    if jc.moe is not None and not experts:
        jc, tc = jc.with_overrides(moe=None), tc.with_overrides(moe=None)
    js, ts = japi.state_struct(jc), tapi.state_struct(tc)
    assert ts["opt"]["count"] == ((), torch.int32)
    for part in ("params", "m", "v"):
        jt = js["params"] if part == "params" else js["opt"][part]
        tt = ts["params"] if part == "params" else ts["opt"][part]
        assert set(jt) == set(tt)
        for k, s in jt.items():
            assert tt[k] == (tuple(s.shape), getattr(torch, str(s.dtype)))


def test_lm_backward_wrappers_refuse_cpu_tensors():
    """The backward wrappers launch only on the card; on the CPU autograd
    differentiates the plain versions through ``ops``."""
    q = torch.zeros(1, 8, 2, 16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        TFA.flash_attention_bwd(q, q, q, q, lse, q)
    q520 = torch.zeros(1, 8, 2, 520, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 1 to 512"):
        TFA.flash_attention_bwd(q520, q520, q520, q520, lse, q520)
    dt = torch.zeros(1, 4, 8)
    hs = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        TSS.selective_scan_bwd(dt, dt, torch.zeros(8, 16),
                               torch.zeros(1, 4, 16), torch.zeros(1, 4, 16),
                               hs, dt)
    with pytest.raises(ValueError, match="d_state"):
        TSS.selective_scan_bwd(dt, dt, torch.zeros(8, 257),
                               torch.zeros(1, 4, 257), torch.zeros(1, 4, 257),
                               torch.zeros(1, 1, 8, 257), dt)
    assert TFA.flash_attention_bwd.launches == 0
    assert TSS.selective_scan_bwd.launches == 0


def test_backward_instances_are_the_cuda_ones():
    """``HEAD_DIMS`` and ``BWD_D_STATES`` list exactly the cases the
    backward entry points of the ``.cu`` sources dispatch: every head dim
    from 1 to 512, bf16 to the tensor-core instance of its width (tc's up
    to 256, wide's 512 above; none on the CUDA cores), f32 to the
    CUDA-core instance of its width; every d_state from 1 to 256 to the
    instance ``instance`` names, past 64 once for each of its
    ``groups``."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    body = src[src.index('extern "C" int flash_attention_bwd_bf16('):
               src.index('extern "C" int flash_attention_bwd_geometry(')]
    assert "dispatch_bf16(" in body and "simt::" not in body
    body = src[src.index("int dispatch_bf16("):src.index("int prologue(")]
    tc = tuple(int(w) for w in re.findall(r"BWD_TC_CASE\((\d+)\)", body))
    assert "case wide::W:" in body and "simt::" not in body
    assert tc + (512,) == tuple(sorted({TFA.tc_width(n, backward=True)
                                        for n in TFA.HEAD_DIMS}))
    assert TFA.BWD_TC_WIDTHS == tc + (512,)
    simt = src[src.index("namespace simt {"):src.index("}  // namespace simt")]
    listed = simt[simt.index("#define SIMT_WIDTH_LIST(X)"):
                  simt.index("// Delta (from o and dO hd wide)")]
    assert tuple(int(w) for w in re.findall(r"X\((\d+)\)", listed)) == \
        TFA.SIMT_BWD_WIDTHS
    disp = simt[simt.index("inline int dispatch("):]
    assert "SIMT_WIDTH_LIST(BWD_SIMT_CASE)" in disp
    assert "slices(hd), nsplit" in disp
    body = src[src.index('extern "C" int flash_attention_bwd_f32('):
               src.index('extern "C" int flash_attention_bwd_bf16(')]
    assert "simt::dispatch(" in body
    assert "restride::copy<uint32_t>(4," in body
    assert TFA.HEAD_DIMS == tuple(range(1, 513))
    # the f32 instances: the gradients' columns of one slice, at most
    # SIMT_MAX_SLICE; two slices past it
    assert max(TFA.SIMT_BWD_WIDTHS) == TFA.SIMT_MAX_SLICE == int(re.search(
        r"constexpr int MAX_SLICE = (\d+);", simt).group(1))
    for hd in TFA.HEAD_DIMS:
        n = TFA.simt_bwd_slices(hd)
        w = TFA.simt_bwd_width(hd)
        assert n == (1 if hd <= 256 else 2)
        assert w in TFA.SIMT_BWD_WIDTHS and n * w >= hd
        assert all(n * v < TFA.ld(hd, torch.float32)
                   for v in TFA.SIMT_BWD_WIDTHS if v < w)
    src = (_build.CSRC / "selective_scan_bwd.cu").read_text()
    body = src[src.index('extern "C" int selective_scan_bwd_f32('):]
    assert tuple(int(n) for n in re.findall(r"SSB_CASE\((\d+)\)", body)) == \
        TSS.INSTANCES
    assert TSS.BWD_D_STATES == tuple(range(1, 257))
    assert sorted({TSS.instance(ds) for ds in TSS.BWD_D_STATES}) == \
        list(TSS.INSTANCES)
    for ds in TSS.BWD_D_STATES:
        assert TSS.groups(ds) == (1 if ds <= 64 else -(-ds // 64))
        assert TSS.width(ds) >= ds


def test_backward_tensor_core_dispatch_is_the_cuda_one():
    """Every bf16 head dim goes to the backward entry point's tensor-core
    kernels (``tc::width``: 64, 128, 256 (129 to 192 among them: no
    instance of width 192) and 512, never 0 in the domain), each on the
    instance ``tc_width(hd, backward=True)`` names; f32 goes to the
    CUDA-core ones, as ``bwd_scope`` says."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    tc = src[src.index("namespace tc {"):src.index("}  // namespace tc")]
    expr = re.search(r"constexpr int width\(int hd\) \{\s+return ([^;]+);",
                     tc).group(1)
    assert expr.replace("\n", " ").split() == (
        "hd < 1 || hd > 512 ? 0 : hd <= 64 ? 64 : hd <= 128 ? 128 "
        ": hd <= 256 ? 256 : 512").split()
    for hd in TFA.HEAD_DIMS:
        assert TFA.bwd_scope(torch.bfloat16, hd) == "tc"
        assert TFA.bwd_scope(torch.float32, hd) == "simt"
        w = TFA.tc_width(hd, backward=True)
        assert w == (64 if hd <= 64 else 128 if hd <= 128 else 256
                     if hd <= 256 else 512)
        assert TFA.bwd_geometry(torch.bfloat16, hd)[:2] == (1, w)


@pytest.mark.parametrize("arch", [STABLELM, JAMBA])
def test_autograd_functions_glue_on_cpu(monkeypatch, lm_jax_states, arch):
    """The card's path through ``ops`` (the autograd functions around the
    kernels, under remat) run on the CPU: ``ops`` is told the tensors lie
    on the card and the kernel wrappers are replaced by their plain
    emulations (the forward with its log-sum-exps or chunk start states,
    ``backward_blocks``, ``backward_chunks``). The loss and every gradient
    equal the plain path's to LM_TOL."""
    from repro_torch.kernels import ops as TOPS

    def fake_fa(q, k, v, lse=False):
        o = TREF.flash_attention(q, k, v)
        return (o, TFA.lse_blocks(q, k)) if lse else o

    def fake_ss(dt, dx, A, Bc, Cc, h0=None, save_states=False,
                scan_dtype="float32"):
        assert scan_dtype == "float32"
        y, h_last = TREF.selective_scan(dt, dx, A, Bc, Cc, h0)
        if not save_states:
            return y, h_last
        h = torch.zeros_like(h_last) if h0 is None else h0
        starts = []
        for t in range(dt.shape[1]):
            if t % TSS.BT == 0:
                starts.append(h)
            h = (torch.exp(dt[:, t, :, None] * A) * h
                 + dx[:, t, :, None] * Bc[:, t, None, :])
        return y, h_last, torch.stack(starts, 1)

    def fake_ss_bwd(dt, dx, A, Bc, Cc, hs, dy, dh_last=None,
                    want_dh0=False, scan_dtype="float32"):
        return TSS.backward_chunks(dt, dx, A, Bc, Cc, dy,
                                   hs[:, 0] if want_dh0 else None, dh_last,
                                   scan_dtype=scan_dtype)

    _, tc = _lm_cfgs(arch)
    batch = _t_batch(_batches(tc.vocab_size, 1)[0])
    runs = []
    for patched in (False, True):
        if patched:
            monkeypatch.setattr(TOPS, "_on_cuda", lambda t: True)
            monkeypatch.setattr(TFA, "flash_attention", fake_fa)
            monkeypatch.setattr(TFA, "flash_attention_bwd",
                                TFA.backward_blocks)
            monkeypatch.setattr(TSS, "selective_scan", fake_ss)
            monkeypatch.setattr(TSS, "selective_scan_bwd", fake_ss_bwd)
        tp = convert.lm_params_from_numpy(lm_jax_states[arch]["params"],
                                          "float32", "cpu")
        names = sorted(tp)
        leaves = [tp[k].requires_grad_() for k in names]
        loss = tapi.loss_fn(tc, dict(zip(names, leaves)), batch)
        runs.append([loss.detach()] + list(torch.autograd.grad(loss,
                                                               leaves)))
    for a, b in zip(*runs):
        _lm_close(a, b)
