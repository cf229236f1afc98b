"""Parity of the PyTorch port's EM building blocks with the JAX package, on
the CPU: the TVM E-step accumulation, M-step and minimum-divergence update,
the UBM M-steps, and the engine's streamed accumulators.

Inputs are made with numpy from a seed and fed to both packages; the port
runs with ``device="cpu"``. Tolerances: 1e-5 relative and absolute for
single products and reductions (f32 summed in another order), 1e-4 where
a Cholesky factor, a solve or a triangular inverse sits between input and
output. ``min_divergence`` diagonalises with ``eigh``, whose eigenvectors
are defined up to sign (and LAPACK, cuSOLVER and JAX may choose
differently), so it is held on quantities that do not change under that
choice: T_c T_c^T, T[:, :, 0] * prior[0] and the prior's norm.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as JEN  # noqa: E402
from repro.core import tvm as JTV  # noqa: E402
from repro.core import ubm as JU  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine as TEN  # noqa: E402
from repro_torch.core import tvm as TTV  # noqa: E402
from repro_torch.core import ubm as TU  # noqa: E402

C, D, R = 8, 5, 6


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ubm_np(seed=0):
    rng = np.random.default_rng(seed)
    means = (2.0 * rng.standard_normal((C, D))).astype(np.float32)
    A = (0.2 * rng.standard_normal((C, D, D))).astype(np.float32)
    covs = (np.einsum("cij,ckj->cik", A, A)
            + np.eye(D, dtype=np.float32)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, C).astype(np.float32)
    return w / w.sum(), means, covs


def _both_models(formulation, seed=1):
    rng = np.random.default_rng(seed)
    _, m, c = _ubm_np(seed)
    T = rng.standard_normal((C, D, R)).astype(np.float32)
    prior = np.zeros(R, np.float32)
    if formulation == "augmented":
        T[:, :, 0] = m / 10.0
        prior[0] = 10.0
    jm = JTV.TVModel(jnp.asarray(T), jnp.asarray(c), jnp.asarray(prior),
                     jnp.asarray(m), formulation)
    tm = convert.tvm_from_numpy(T, c, prior, m, formulation, device="cpu")
    return jm, tm


def _nf(seed, U_):
    rng = np.random.default_rng(seed)
    n = rng.uniform(0.5, 5.0, (U_, C)).astype(np.float32)
    f = rng.standard_normal((U_, C, D)).astype(np.float32)
    return n, f


def _invariants(T, prior):
    """Quantities of a TV model that min_divergence's eigenvector signs do
    not change."""
    T, prior = np.asarray(T), np.asarray(prior)
    return (np.einsum("cdr,cer->cde", T, T), T[:, :, 0] * prior[0],
            np.linalg.norm(prior))


def _close_rel(got, want, tol):
    """|got - want| <= tol * max|want|: the agreement the invariants are
    held to (their entries span several orders of magnitude)."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-12)


@pytest.mark.parametrize("estep,estep_dtype", [
    ("packed", "float32"), ("dense", "float32"), ("packed", "bfloat16")])
def test_em_accumulate_matches_jax(estep, estep_dtype):
    jm, tm = _both_models("augmented")
    n, f = _nf(2, 7)
    jacc = JTV.em_accumulate(jm, JTV.precompute(jm, estep), jnp.asarray(n),
                             jnp.asarray(f), estep_dtype=estep_dtype)
    tacc = TTV.em_accumulate(tm, TTV.precompute(tm, estep, device="cpu"),
                             _t(n), _t(f), estep_dtype=estep_dtype)
    for got, want in zip(tacc, jacc):
        _close_rel(got, want, 1e-4)


def test_em_accumulate_scan_with_remainder_matches_jax():
    """10 utterances in chunks of 4: two whole chunks, then a remainder of
    2, merged in the scan's order."""
    jm, tm = _both_models("augmented")
    n, f = _nf(3, 10)
    jacc = JTV.em_accumulate_scan(jm, JTV.precompute(jm, "packed"),
                                  jnp.asarray(n), jnp.asarray(f), chunk=4)
    tpre = TTV.precompute(tm, "packed", device="cpu")
    tacc = TTV.em_accumulate_scan(tm, tpre, _t(n), _t(f), chunk=4)
    for got, want in zip(tacc, jacc):
        _close_rel(got, want, 1e-4)
    whole = TTV.em_accumulate(tm, tpre, _t(n), _t(f))
    for got, want in zip(tacc, whole):
        _close_rel(got, want, 1e-4)
    assert float(tacc.n_utts) == 10.0


@pytest.mark.parametrize("estep,update_sigma", [
    ("packed", True), ("dense", True), ("packed", False)])
def test_m_step_matches_jax(estep, update_sigma):
    jm, tm = _both_models("augmented")
    n, f = _nf(4, 9)
    jacc = JTV.em_accumulate(jm, JTV.precompute(jm, estep), jnp.asarray(n),
                             jnp.asarray(f))
    tacc = TTV.EMAccum(*(_t(a) for a in jacc))
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((C, 40, D)).astype(np.float32)
    S = np.einsum("cfi,cfj->cij", xs, xs) * 3.0   # an SPD second moment
    jnew = JTV.m_step(jm, jacc, jnp.asarray(S), update_sigma)
    tnew = TTV.m_step(tm, tacc, _t(S), update_sigma)
    _close_rel(tnew.T, jnew.T, 1e-4)
    _close_rel(tnew.Sigma, jnew.Sigma, 1e-4)
    assert torch.equal(tnew.Sigma, tnew.Sigma.transpose(1, 2))
    if not update_sigma:
        assert torch.equal(tnew.Sigma, tm.Sigma)


@pytest.mark.parametrize("formulation", ["standard", "augmented"])
def test_min_divergence_matches_jax_on_invariants(formulation):
    jm, tm = _both_models(formulation)
    n, f = _nf(6, 12)
    jacc = JTV.em_accumulate(jm, JTV.precompute(jm, "packed"),
                             jnp.asarray(n), jnp.asarray(f))
    tacc = TTV.EMAccum(*(_t(a) for a in jacc))
    jnew = JTV.min_divergence(jm, jacc, update_means=True)
    tnew = TTV.min_divergence(tm, tacc, update_means=True)
    for got, want in zip(_invariants(tnew.T, tnew.prior),
                         _invariants(jnew.T, jnew.prior)):
        _close_rel(got, want, 1e-4)
    _close_rel(tnew.means, jnew.means, 1e-5)
    _close_rel(TTV.updated_ubm_means(tnew), JTV.updated_ubm_means(jnew),
               1e-4)
    if formulation == "augmented":
        # the prior is rotated onto e1: (|P1 h|, 0, ..., 0)
        assert float(tnew.prior[0]) > 0
        assert float(tnew.prior[1:].abs().max()) <= 1e-4 * float(
            tnew.prior[0])


def test_ubm_m_steps_and_floors_match_jax():
    rng = np.random.default_rng(7)
    n = rng.uniform(0.0, 30.0, C).astype(np.float32)
    n[3] = 0.0                                      # an empty component
    f = rng.standard_normal((C, D)).astype(np.float32) * n[:, None]
    xs = rng.standard_normal((C, 50, D)).astype(np.float32)
    ss_full = np.einsum("cfi,cfj->cij", xs, xs).astype(np.float32)
    ss_diag = np.einsum("cii->ci", ss_full).copy()
    jd = JU.diag_m_step(jnp.asarray(n), jnp.asarray(f), jnp.asarray(ss_diag))
    td = TU.diag_m_step(_t(n), _t(f), _t(ss_diag))
    for got, want in zip((td.weights, td.means, td.vars),
                         (jd.weights, jd.means, jd.vars)):
        _close(got, want)
    jf = JU.full_m_step(jnp.asarray(n), jnp.asarray(f), jnp.asarray(ss_full))
    tf = TU.full_m_step(_t(n), _t(f), _t(ss_full))
    for got, want in zip((tf.weights, tf.means, tf.covs),
                         (jf.weights, jf.means, jf.covs)):
        _close(got, want, 1e-4)
    _close(TU.renormalised_weights(_t(n)),
           JU.renormalised_weights(jnp.asarray(n)))
    _close(TU.full_from_diag(td).covs, JU.full_from_diag(jd).covs)
    # an indefinite matrix is floored to spectrum >= floor
    bad = ss_full / 50.0 - 2.0 * np.eye(D, dtype=np.float32)
    got = TU.psd_floor(_t(bad))
    _close(got, JU.psd_floor(jnp.asarray(bad)), 1e-4)
    assert float(torch.linalg.eigvalsh(got).min()) >= TU.VAR_FLOOR * 0.99


@pytest.mark.parametrize("masked", [False, True])
def test_init_diag_from_data_draws_valid_frames(masked):
    """Different generators draw different frames, so the port is held to
    what the draw must satisfy: C distinct valid frames as means, and the
    same (deterministic) global variance and weights as JAX."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((6, 20, D)).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.uniform(size=(6, 20)) < 0.7).astype(np.float32)
        x[mask == 0] = 1e6                          # never a valid draw
    g = torch.Generator().manual_seed(0)
    got = TU.init_diag_from_data(_t(x), C, g,
                                 mask=None if mask is None else _t(mask))
    want = JU.init_diag_from_data(jnp.asarray(x), C, jax.random.PRNGKey(0),
                                  mask=None if mask is None
                                  else jnp.asarray(mask))
    _close(got.vars, want.vars, 1e-5)
    _close(got.weights, want.weights)
    rows = x.reshape(-1, D)[None] if mask is None else \
        x.reshape(-1, D)[mask.reshape(-1) > 0][None]
    hit = (np.abs(got.means.numpy()[:, None] - rows) == 0).all(-1)
    assert hit.any(1).all()
    assert len({tuple(r) for r in got.means.numpy()}) == C


def test_as_utterances_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((50, D)).astype(np.float32)
    for mask in (None, (rng.uniform(size=50) < 0.8).astype(np.float32)):
        jf, jm = JU._as_utterances(
            jnp.asarray(x), None if mask is None else jnp.asarray(mask), 16)
        tf, tm = TU._as_utterances(
            _t(x), None if mask is None else _t(mask), 16)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def _stream_inputs(seed=10, U_=10, F=12, garbage=3):
    rng = np.random.default_rng(seed)
    w, m, c = _ubm_np(seed)
    comp = rng.choice(C, size=(U_, F), p=w)
    x = (m[comp] + rng.standard_normal((U_, F, D))).astype(np.float32)
    mask = np.ones((U_, F), np.float32)
    mask[-1, F - garbage:] = 0.0
    x[-1, F - garbage:] = np.nan
    mask[2, :] = 0.0                                # an all-padding utterance
    return (w, m, c), x, mask


@pytest.mark.parametrize("rescore,second_order", [
    ("sparse", "full"), ("fused", "diag"), ("dense", None)])
def test_stream_accumulators_match_jax(rescore, second_order):
    """TotalsAccum and TVMAccum over 10 masked utterances in chunks of 4
    (a remainder chunk of 2), with per-utterance n/f collected."""
    (w, m, c), x, mask = _stream_inputs()
    jubm = JU.FullGMM(jnp.asarray(w), jnp.asarray(m), jnp.asarray(c))
    tubm = convert.ubm_from_numpy(w, m, c, device="cpu")
    jm, tm = _both_models("augmented")
    spec = dict(n_components=C, top_k=4, floor=0.025,
                second_order=second_order, chunk=4, rescore=rescore)
    js, ts = JEN.EngineSpec(**spec), TEN.EngineSpec(**spec)
    jacc = (JEN.TotalsAccum(js, D),
            JEN.TVMAccum(jm, JTV.precompute(jm, "packed")))
    tacc = (TEN.TotalsAccum(ts, D),
            TEN.TVMAccum(tm, TTV.precompute(tm, "packed", device="cpu")))
    (jtot, jem), (jn, jf) = JEN.stream(js, JEN.pack_ubm(jubm),
                                       jnp.asarray(x), jnp.asarray(mask),
                                       jacc, collect_nf=True)
    (ttot, tem), (tn, tf) = TEN.stream(ts, TEN.pack_ubm(tubm, "cpu"),
                                       _t(x), _t(mask), tacc,
                                       collect_nf=True)
    for got, want in zip(ttot, jtot):
        if want is None:
            assert got is None
        else:
            _close_rel(got, want, 1e-5)
    for got, want in zip(tem, jem):
        _close_rel(got, want, 1e-4)
    _close(tn, jn)
    _close(tf, jf, 1e-4)
    assert float(ttot.frames) == mask.sum()
    # stream_bw / stream_ubm are the same pass
    tb, (ll, fr) = TEN.stream_bw(ts, TEN.pack_ubm(tubm, "cpu"), _t(x),
                                 _t(mask))
    assert torch.equal(tb.n, tn) and torch.equal(ll, ttot.loglik)
    tu = TEN.stream_ubm(ts, TEN.pack_ubm(tubm, "cpu"), _t(x), _t(mask))
    assert torch.equal(tu.n, ttot.n)


def test_stream_diag_pack_matches_jax():
    """The diagonal phase of UBM EM: no full UBM, all C components kept."""
    (w, m, c), x, mask = _stream_inputs(11)
    v = np.einsum("cii->ci", c).copy()
    spec = dict(n_components=C, top_k=C, floor=0.0, second_order="diag",
                chunk=3)
    jst = JEN.stream_ubm(JEN.EngineSpec(**spec),
                         JEN.pack_diag(JU.DiagGMM(jnp.asarray(w),
                                                  jnp.asarray(m),
                                                  jnp.asarray(v))),
                         jnp.asarray(x), jnp.asarray(mask))
    tst = TEN.stream_ubm(TEN.EngineSpec(**spec),
                         TEN.pack_diag(convert.diag_from_numpy(
                             w, m, v, device="cpu")),
                         _t(x), _t(mask))
    for got, want in zip(tst, jst):
        _close_rel(got, want, 1e-5)
