"""Parity of the PyTorch port's scoring backend (``repro_torch/core/backend.py``)
and of its data helpers (``repro_torch/data/speech.py``) with the JAX
package, on the CPU.

Both packages get the same numpy i-vectors: a well-conditioned
speaker-plus-channel draw (12 speakers x 8 utterances, R = 12).

What is compared, and to what tolerance:

* ``train_lda`` / ``train_plda`` run on the host in f64 numpy/scipy in both
  packages: bitwise equal.
* ``whitener`` (f32 ``eigh`` in each package): W to 1e-4 x max|W|.
* ``apply_lda`` and the PLDA scores (matrix and pairs) of the same models:
  1e-5 x max|value| (f32 products summed in another order, through two
  Cholesky factors).
* ``_plda_coeffs`` against an f64 numpy reference that solves without
  the Schur identity (the joint log-determinant by ``slogdet``): 1e-4 x
  max|value| (f32 Cholesky of T and S).
* ``eer`` of the same scores, ``make_trials`` of the same seed and
  ``utterance_lengths``: equal.
* ``plda_score_pairs`` against the diagonal of ``plda_score_matrix``:
  1e-5 x max|score|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import backend as JBK  # noqa: E402
from repro.data import speech as JDS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import artifacts as TAR  # noqa: E402
from repro_torch.core import backend as TBK  # noqa: E402
from repro_torch.data import speech as TDS  # noqa: E402

N_SPK, N_UTT, R, K = 12, 8, 12, 8
W_TOL = 1e-4
SCORE_TOL = 1e-5
COEFF_TOL = 1e-4


def _close_rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-12), err


@pytest.fixture(scope="module")
def ivecs():
    """(i-vectors [96, R] f32, speaker labels [96])."""
    rng = np.random.default_rng(3)
    spk = 1.5 * rng.standard_normal((N_SPK, R))
    ch = 0.5 * rng.standard_normal((N_SPK * N_UTT, R))
    x = np.repeat(spk, N_UTT, axis=0) + ch + 0.2
    return x.astype(np.float32), np.repeat(np.arange(N_SPK), N_UTT)


@pytest.fixture(scope="module")
def models(ivecs):
    """(JAX LDA, JAX PLDA) trained on length-normed, LDA-projected data,
    and the projected data."""
    x, labels = ivecs
    xn = np.asarray(JBK.length_norm(jnp.asarray(x)))
    lda = JBK.train_lda(xn, labels, K)
    xl = np.asarray(JBK.apply_lda(lda, jnp.asarray(xn)))
    return lda, JBK.train_plda(xl, labels), xl


def _t(a):
    return torch.from_numpy(np.array(a))


def test_train_lda_bitwise(ivecs):
    x, labels = ivecs
    want = JBK.train_lda(x, labels, K)
    got = TBK.train_lda(_t(x), labels, K)
    assert got.proj.device.type == "cpu"
    np.testing.assert_array_equal(got.mean.numpy(), np.asarray(want.mean))
    np.testing.assert_array_equal(got.proj.numpy(), np.asarray(want.proj))


def test_train_plda_bitwise(ivecs):
    x, labels = ivecs
    want = JBK.train_plda(x, labels)
    got = TBK.train_plda(x, labels, device="cpu")
    for g, w in ((got.mean, want.mean), (got.B, want.B), (got.W, want.W)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_whitener(ivecs):
    x, _ = ivecs
    jmu, jW = JBK.whitener(jnp.asarray(x))
    mu, W = TBK.whitener(_t(x))
    _close_rel(mu, jmu, SCORE_TOL)
    _close_rel(W, jW, W_TOL)
    # it whitens: the centred data's covariance becomes the identity
    xc = (_t(x) - mu) @ W.T
    cov = (xc.T @ xc / x.shape[0]).numpy()
    np.testing.assert_allclose(cov, np.eye(R), atol=1e-3)


def test_apply_lda(ivecs, models):
    x, _ = ivecs
    lda, _, _ = models
    tlda = TBK.LDA(_t(lda.mean), _t(lda.proj))
    _close_rel(TBK.apply_lda(tlda, _t(x)),
               JBK.apply_lda(lda, jnp.asarray(x)), SCORE_TOL)


def test_plda_scores(models):
    _, plda, xl = models
    tplda = TBK.PLDA(_t(plda.mean), _t(plda.B), _t(plda.W))
    e, t = xl[:40], xl[40:]
    _close_rel(TBK.plda_score_matrix(tplda, _t(e), _t(t)),
               JBK.plda_score_matrix(plda, jnp.asarray(e), jnp.asarray(t)),
               SCORE_TOL)
    a, b = xl[:50], xl[46:]
    _close_rel(TBK.plda_score_pairs(tplda, _t(a), _t(b)),
               JBK.plda_score_pairs(plda, jnp.asarray(a), jnp.asarray(b)),
               SCORE_TOL)


def test_plda_pairs_are_matrix_diagonal(models):
    _, plda, xl = models
    tplda = TBK.PLDA(_t(plda.mean), _t(plda.B), _t(plda.W))
    a, b = _t(xl[:48]), _t(xl[48:])
    _close_rel(TBK.plda_score_pairs(tplda, a, b),
               torch.diagonal(TBK.plda_score_matrix(tplda, a, b)), SCORE_TOL)


def test_plda_coeffs_against_f64(models):
    _, plda, _ = models
    B = np.asarray(plda.B, np.float64)
    W = np.asarray(plda.W, np.float64)
    T = B + W
    D = T.shape[0]
    joint = np.block([[T, B], [B, T]])
    Jinv = np.linalg.solve(joint, np.eye(2 * D))
    Tinv = np.linalg.solve(T, np.eye(D))
    # llr = log N([x;y]; joint) - log N(x; T) - log N(y; T)
    Q_ref = Tinv - Jinv[:D, :D]
    P_ref = -Jinv[:D, D:]
    const_ref = -0.5 * (np.linalg.slogdet(joint)[1]
                        - 2 * np.linalg.slogdet(T)[1])
    Q, P, const = TBK._plda_coeffs(
        TBK.PLDA(_t(plda.mean), _t(plda.B), _t(plda.W)))
    _close_rel(Q, Q_ref, COEFF_TOL)
    _close_rel(P, P_ref, COEFF_TOL)
    assert abs(float(const) - const_ref) <= COEFF_TOL * max(abs(const_ref),
                                                           1.0)


def test_spd_inverse_against_f64(models):
    _, plda, _ = models
    M = np.asarray(plda.B, np.float64) + np.asarray(plda.W, np.float64)
    inv, logdet = TBK._spd_inverse(_t(M.astype(np.float32)))
    _close_rel(inv, np.linalg.solve(M, np.eye(M.shape[0])), COEFF_TOL)
    assert torch.equal(inv, inv.T)
    assert abs(float(logdet) - np.linalg.slogdet(M)[1]) <= 1e-4


def test_eer_equal(models):
    rng = np.random.default_rng(5)
    scores = np.concatenate([rng.normal(1.0, 1.0, 500),
                             rng.normal(-1.0, 1.0, 500)]).astype(np.float32)
    y = np.concatenate([np.ones(500), np.zeros(500)])
    want = JBK.eer(jnp.asarray(scores), y)
    assert TBK.eer(_t(scores), y) == want
    assert 0.1 < want < 0.3


def test_make_trials_equal():
    labels = np.repeat(np.arange(9), 5)
    ids = np.arange(len(labels))
    want = JDS.make_trials(labels, ids, np.random.default_rng(11), 600)
    got = TDS.make_trials(labels, ids, np.random.default_rng(11), 600)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_utterance_lengths_equal():
    cfg = dict(n_speakers=5, utts_per_speaker=4, frames_per_utt=80,
               min_frames_per_utt=20, seed=3)
    np.testing.assert_array_equal(
        TDS.utterance_lengths(TDS.SpeechDataConfig(**cfg)),
        JDS.utterance_lengths(JDS.SpeechDataConfig(**cfg)))


def test_build_dataset_deterministic_and_ragged():
    cfg = TDS.SpeechDataConfig(feat_dim=6, n_components=4, n_speakers=3,
                               utts_per_speaker=2, frames_per_utt=30,
                               min_frames_per_utt=10, speaker_rank=3,
                               channel_rank=2)
    feats, labels = TDS.build_dataset(cfg, device="cpu")
    assert feats.shape == (6, 30, 6) and torch.isfinite(feats).all()
    np.testing.assert_array_equal(labels, [0, 0, 1, 1, 2, 2])
    again, _ = TDS.build_dataset(cfg, device="cpu")
    assert torch.equal(feats, again)
    ragged, _ = TDS.build_ragged_dataset(cfg, device="cpu")
    for u, n, full in zip(ragged, TDS.utterance_lengths(cfg), feats):
        assert torch.equal(u, full[:n])
    # another seed draws other frames
    other, _ = TDS.build_dataset(
        TDS.SpeechDataConfig(**{**cfg.__dict__, "seed": 1}), device="cpu")
    assert not torch.equal(feats, other)


def test_backend_from_numpy(models):
    lda, plda, xl = models
    art = convert.backend_from_numpy(
        np.zeros(R, np.float32), lda.mean, lda.proj, plda.mean, plda.B,
        plda.W, device="cpu")
    assert art.whitener is None
    np.testing.assert_array_equal(art.plda.B.numpy(), np.asarray(plda.B))
    s = TAR.score_trials(art, xl, np.arange(10), np.arange(10, 20))
    _close_rel(s, JBK.plda_score_pairs(plda, jnp.asarray(xl[:10]),
                                       jnp.asarray(xl[10:20])), SCORE_TOL)
