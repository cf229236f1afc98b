"""Parity of the PyTorch port's training path (``ubm.train_ubm``,
``trainer.train`` in both of its branches, ``trainer.extract``) with the JAX
package, on the CPU.

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
