"""Parity of the PyTorch port's core (UBM, alignment, Baum-Welch statistics,
TVM posterior, chunk body) with the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages; the port
runs with ``device="cpu"``. Tolerances: 1e-5 relative and absolute for
single products and reductions (f32 summed in another order), 1e-4 where
a Cholesky factor or a triangular inverse sits between input and output.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro_torch  # noqa: E402
from repro.core import alignment as JAL  # noqa: E402
from repro.core import engine as JEN  # noqa: E402
from repro.core import stats as JST  # noqa: E402
from repro.core import tvm as JTV  # noqa: E402
from repro.core import ubm as JU  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import alignment as TAL  # noqa: E402
from repro_torch.core import engine as TEN  # noqa: E402
from repro_torch.core import stats as TST  # noqa: E402
from repro_torch.core import tvm as TTV  # noqa: E402
from repro_torch.core import ubm as TU  # noqa: E402

C, D, R = 8, 5, 6


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _ubm_np(seed=0, C=C, D=D):
    rng = np.random.default_rng(seed)
    means = (2.0 * rng.standard_normal((C, D))).astype(np.float32)
    A = (0.2 * rng.standard_normal((C, D, D))).astype(np.float32)
    covs = (np.einsum("cij,ckj->cik", A, A)
            + np.eye(D, dtype=np.float32)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, C).astype(np.float32)
    return w / w.sum(), means, covs


def _both_ubms(seed=0):
    w, m, c = _ubm_np(seed)
    return (JU.FullGMM(jnp.asarray(w), jnp.asarray(m), jnp.asarray(c)),
            convert.ubm_from_numpy(w, m, c, device="cpu"))


def _both_models(formulation, seed=1):
    rng = np.random.default_rng(seed)
    w, m, c = _ubm_np(seed)
    T = rng.standard_normal((C, D, R)).astype(np.float32)
    prior = np.zeros(R, np.float32)
    if formulation == "augmented":
        T[:, :, 0] = m / 10.0
        prior[0] = 10.0
    jm = JTV.TVModel(jnp.asarray(T), jnp.asarray(c), jnp.asarray(prior),
                     jnp.asarray(m), formulation)
    tm = convert.tvm_from_numpy(T, c, prior, m, formulation, device="cpu")
    return jm, tm


def _frames(seed, F, garbage=0):
    """[F, D] frames; the last ``garbage`` rows hold overflow-scale values,
    inf and NaN, with a mask that marks them invalid."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((F, D)).astype(np.float32)
    mask = np.ones(F, np.float32)
    if garbage:
        x[F - garbage:] = 1e25 * rng.standard_normal((garbage, D))
        x[F - garbage] = np.inf
        x[F - garbage + 1] = np.nan
        mask[F - garbage:] = 0.0
    return x, mask


def test_full_precisions_and_diag_loglik_match_jax():
    jubm, tubm = _both_ubms()
    for got, want in zip(TU.full_precisions(tubm), JU.full_precisions(jubm)):
        _close(got, want, 1e-4)
    x, _ = _frames(3, 40)
    _close(TU.diag_loglik(tubm.to_diag(), torch.from_numpy(x)),
           JU.diag_loglik(jubm.to_diag(), jnp.asarray(x)))
    P = TU.full_precisions(tubm)[2]
    assert torch.equal(P, P.transpose(1, 2))


@pytest.mark.parametrize("rescore", ["dense", "sparse", "fused"])
def test_align_frames_matches_jax_with_garbage_mask(rescore):
    """Masked NaN/inf/overflow frames get all-zero posteriors (where, not
    multiply); valid frames match JAX's selected ids and posteriors."""
    jubm, tubm = _both_ubms()
    x, mask = _frames(4, 48, garbage=6)
    (jp, jl) = JAL.align_frames(jnp.asarray(x), jubm, jubm.to_diag(),
                                top_k=4, floor=0.025,
                                mask=jnp.asarray(mask), with_loglik=True,
                                rescore=rescore)
    (tp, tl) = TAL.align_frames(torch.from_numpy(x), tubm, tubm.to_diag(),
                                top_k=4, floor=0.025,
                                mask=torch.from_numpy(mask),
                                with_loglik=True, rescore=rescore)
    valid = mask > 0
    np.testing.assert_array_equal(tp.indices.numpy()[valid],
                                  np.asarray(jp.indices)[valid])
    _close(tp.values, jp.values)
    _close(tl, jl, 1e-4)
    assert np.isfinite(tp.values.numpy()).all()
    assert (tp.values.numpy()[~valid] == 0).all()


@pytest.mark.parametrize("rescore", ["dense", "sparse", "fused"])
def test_rescore_selected_matches_jax(rescore):
    """Each rung's selected-set scores against JAX's ``rescore_selected``
    on the same selection. The port runs 'fused' only inside
    ``align_frames`` (one ``gmm_align`` call), so ``rescore_selected``
    refuses it and the packed-row scorer is ``ubm.full_rescore_fused``."""
    jubm, tubm = _both_ubms()
    x, _ = _frames(5, 40)
    jdiag, jsel = JAL.preselect(jubm.to_diag(), jnp.asarray(x), 4)
    want = JAL.rescore_selected(jnp.asarray(x), jsel, jubm, jdiag,
                                rescore=rescore)
    xt = torch.from_numpy(x)
    sel = torch.from_numpy(np.array(jsel)).long()
    if rescore == "fused":
        got = TU.full_rescore_fused(tubm, xt, sel)
        with pytest.raises(ValueError, match="'dense' or 'sparse'"):
            TAL.rescore_selected(xt, sel, tubm, None, rescore="fused")
    else:
        got = TAL.rescore_selected(xt, sel, tubm, None, rescore=rescore)
    _close(got, want, 1e-4)


def test_tied_topk_breaks_toward_lowest_id():
    """Components 1, 3 and 6 are copies of component 0 and 2 of 5, so
    their diag scores tie exactly: ``lax.top_k`` keeps the lowest ids
    first, and so must the port's preselect."""
    w, m, c = _ubm_np(6)
    for dst, src in ((1, 0), (3, 0), (6, 0), (2, 5)):
        m[dst], c[dst] = m[src], c[src]
    w = np.full(C, 1.0 / C, np.float32)
    jubm = JU.FullGMM(jnp.asarray(w), jnp.asarray(m), jnp.asarray(c))
    tubm = convert.ubm_from_numpy(w, m, c, device="cpu")
    x = m[[0, 5, 0, 4]] + 0.01
    for k in (2, 3, 5):
        _, jsel = JAL.preselect(jubm.to_diag(), jnp.asarray(x), k)
        _, tsel = TAL.preselect(tubm.to_diag(), torch.from_numpy(x), k)
        np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    assert tsel.numpy()[0, :4].tolist() == [0, 1, 3, 6]


def test_floor_renormalise_keeps_argmax():
    rng = np.random.default_rng(8)
    post = rng.dirichlet(np.ones(6), size=10).astype(np.float32)
    for floor in (0.025, 0.9):
        got = TAL.floor_renormalise(torch.from_numpy(post), floor)
        _close(got, JAL.floor_renormalise(jnp.asarray(post), floor))
        _close(got.sum(1), np.ones(10))


@pytest.mark.parametrize("second_order", [None, "diag", "full"])
def test_scatter_accumulate_matches_jax(second_order):
    """Duplicate ids inside a frame and masked garbage frames included."""
    rng = np.random.default_rng(9)
    U_, F, K = 3, 12, 4
    N = U_ * F
    x, mask = _frames(10, N, garbage=5)
    vals = rng.uniform(0, 1, (N, K)).astype(np.float32)
    vals[N - 5:] = np.nan
    idx = rng.integers(0, C, (N, K)).astype(np.int64)
    idx[0, 1] = idx[0, 0]
    utt = np.repeat(np.arange(U_), F)
    jn, jf, jS = JST.scatter_accumulate(
        jnp.asarray(x), jnp.asarray(vals), jnp.asarray(idx),
        jnp.asarray(utt), U_, C, second_order=second_order,
        mask=jnp.asarray(mask))
    tn, tf, tS = TST.scatter_accumulate(
        torch.from_numpy(x), torch.from_numpy(vals), torch.from_numpy(idx),
        U_, C, second_order=second_order, mask=torch.from_numpy(mask))
    _close(tn, jn)
    _close(tf, jf)
    if second_order is None:
        assert tS is None and jS is None
    else:
        _close(tS, jS, 1e-4)
    assert np.isfinite(tf.numpy()).all()


def test_center_matches_jax():
    rng = np.random.default_rng(11)
    n = rng.uniform(0, 3, (2, C)).astype(np.float32)
    f = rng.standard_normal((2, C, D)).astype(np.float32)
    S = rng.standard_normal((C, D, D)).astype(np.float32)
    m = rng.standard_normal((C, D)).astype(np.float32)
    js = JST.center(JST.BWStats(jnp.asarray(n), jnp.asarray(f),
                                jnp.asarray(S)), jnp.asarray(m))
    ts = TST.center(TST.BWStats(torch.from_numpy(n), torch.from_numpy(f),
                                torch.from_numpy(S)), torch.from_numpy(m))
    for got, want in zip(ts, js):
        _close(got, want, 1e-4)


@pytest.mark.parametrize("estep", ["packed", "dense"])
def test_precompute_matches_jax(estep):
    jm, tm = _both_models("augmented")
    jpre = JTV.precompute(jm, estep=estep)
    tpre = TTV.precompute(tm, estep=estep, device="cpu")
    assert tpre.packed == (estep == "packed")
    _close(tpre.U, jpre.U, 1e-4)
    _close(tpre.Pj, jpre.Pj, 1e-4)


@pytest.mark.parametrize("formulation", ["standard", "augmented"])
@pytest.mark.parametrize("estep", ["packed", "dense"])
@pytest.mark.parametrize("mean_only", [False, True])
def test_posterior_matches_jax(formulation, estep, mean_only):
    jm, tm = _both_models(formulation)
    rng = np.random.default_rng(12)
    n = rng.uniform(0.5, 5.0, (5, C)).astype(np.float32)
    n[4] = 0.0                                 # an empty utterance
    f = rng.standard_normal((5, C, D)).astype(np.float32)
    jphi, jPhi = JTV.posterior(jm, JTV.precompute(jm, estep), jnp.asarray(n),
                               jnp.asarray(f), mean_only=mean_only)
    tphi, tPhi = TTV.posterior(tm, TTV.precompute(tm, estep, device="cpu"),
                               torch.from_numpy(n), torch.from_numpy(f),
                               mean_only=mean_only)
    _close(tphi, jphi, 1e-4)
    if mean_only:
        assert tPhi is None and jPhi is None
    else:
        _close(tPhi, jPhi, 1e-4)
    _close(TTV.extract_ivectors(tm, TTV.precompute(tm, estep, device="cpu"),
                                torch.from_numpy(n), torch.from_numpy(f)),
           JTV.extract_ivectors(jm, JTV.precompute(jm, estep),
                                jnp.asarray(n), jnp.asarray(f)), 1e-4)


@pytest.mark.parametrize("rescore", ["dense", "sparse", "fused"])
def test_chunk_body_and_session_stats_match_jax(rescore):
    jubm, tubm = _both_ubms(13)
    x, mask = _frames(14, 2 * 16, garbage=3)
    feats, m2 = x.reshape(2, 16, D), mask.reshape(2, 16)
    js = JEN.EngineSpec(n_components=C, top_k=4, floor=0.025,
                        second_order="full", rescore=rescore)
    ts = TEN.EngineSpec(n_components=C, top_k=4, floor=0.025,
                        second_order="full", rescore=rescore)
    jcs = JEN.chunk_body(js, JEN.pack_ubm(jubm), jnp.asarray(feats),
                         jnp.asarray(m2))
    tpack = TEN.pack_ubm(tubm, device="cpu")
    tcs = TEN.chunk_body(ts, tpack, torch.from_numpy(feats),
                         torch.from_numpy(m2))
    for got, want in zip(tcs, jcs):
        _close(got, want, 1e-4)
    jss = JEN.session_stats(js, JEN.pack_ubm(jubm), jnp.asarray(feats[0]),
                            jnp.asarray(m2[0]))
    tss = TEN.session_stats(ts, tpack, torch.from_numpy(feats[0]),
                            torch.from_numpy(m2[0]))
    for got, want in zip(tss, jss):
        _close(got, want, 1e-4)


def test_degrade_ladder_matches_jax():
    assert TEN.RESCORE_LADDER == JEN.RESCORE_LADDER
    for mode in TEN.RESCORE_LADDER:
        assert TEN.degrade_rescore(mode) == JEN.degrade_rescore(mode)


def test_init_model_augmented_layout():
    _, tubm = _both_ubms()
    g = torch.Generator().manual_seed(0)
    m = TTV.init_model(g, tubm.means, tubm.covs, R, "augmented",
                       prior_offset=50.0)
    assert m.T.shape == (C, D, R) and m.rank == R
    _close(m.T[:, :, 0], tubm.means / 50.0)
    assert m.prior.tolist() == [50.0] + [0.0] * (R - 1)
    g2 = torch.Generator().manual_seed(0)
    m2 = TTV.init_model(g2, tubm.means, tubm.covs, R, "standard")
    assert torch.equal(m.T[:, :, 1:], m2.T[:, :, 1:])
    assert not m2.prior.any()


def test_entry_points_default_to_cuda_and_refuse_without_it(monkeypatch):
    """No card and no explicit device: a clear error, never a silent run
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w, m, c = _ubm_np()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.ubm_from_numpy(w, m, c)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEN.pack_ubm(convert.ubm_from_numpy(w, m, c, device="cpu"))
    assert repro_torch.resolve_device("cpu").type == "cpu"
