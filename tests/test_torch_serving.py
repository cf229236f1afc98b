"""Parity of the PyTorch port's serving session with the JAX package's, on the
CPU, and the port's import isolation.

The JAX ``IVectorExtractor`` and the port's serve the same ragged requests
(spanning several power-of-two buckets, with non-finite frames, a
truncated and an empty request) on a toy model carried across by
``repro_torch.convert``. Tolerance on the length-normed i-vectors: 1e-5
absolute (the same f32 statistics, summed in another order, through a
Cholesky and a triangular inverse); the request counters must be equal.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.ivector_tvm import SMOKE as J_SMOKE  # noqa: E402
from repro.core import trainer as JTR  # noqa: E402
from repro.core import tvm as JTV  # noqa: E402
from repro.core import ubm as JU  # noqa: E402
from repro.serving import IVectorExtractor as JEx  # noqa: E402
from repro.serving import ServingConfig as JSC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.ivector_tvm import SMOKE as T_SMOKE  # noqa: E402
from repro_torch.serving import IVectorExtractor as TEx  # noqa: E402
from repro_torch.serving import ServingConfig as TSC  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)
C, D, R = 8, 5, 6
TOL = 1e-5


def _toy_state(formulation):
    """The JAX toy state of ``tests/test_serving.py`` and its port."""
    key = jax.random.fold_in(KEY, 30)
    means = jax.random.normal(key, (C, D)) * 2
    A = jax.random.normal(jax.random.fold_in(key, 1), (C, D, D)) * 0.2
    covs = jnp.einsum("cij,ckj->cik", A, A) + jnp.eye(D)
    ubm = JU.FullGMM(jnp.ones((C,)) / C, means, covs)
    model = JTV.init_model(jax.random.fold_in(KEY, 31), ubm.means,
                           ubm.covs, R, formulation, prior_offset=10.0)
    tubm = convert.ubm_from_numpy(
        *(np.asarray(a) for a in (ubm.weights, ubm.means, ubm.covs)),
        device="cpu")
    tmodel = convert.tvm_from_numpy(
        *(np.asarray(a) for a in (model.T, model.Sigma, model.prior,
                                  model.means)),
        formulation, device="cpu")
    return JTR.TrainState(model=model, ubm=ubm), (tmodel, tubm)


def _cfgs(formulation, **kw):
    over = dict(feat_dim=D, n_components=C, ivector_dim=R,
                posterior_top_k=4, formulation=formulation, **kw)
    return J_SMOKE.with_overrides(**over), T_SMOKE.with_overrides(**over)


def _requests(seed=0):
    """Ragged lengths over the 16/32/64 buckets (max_bucket 64 truncates
    the 90-frame one), non-finite frames, and an all-NaN request."""
    rng = np.random.default_rng(seed)
    utts = [rng.standard_normal((L, D)).astype(np.float32)
            for L in (10, 17, 16, 33, 7, 64, 40, 90, 12)]
    utts[1][3] = np.nan
    utts[3][[0, 5]] = np.inf
    utts.append(np.full((5, D), np.nan, np.float32))
    return utts


SERVING = dict(max_batch=4, min_bucket=16, max_bucket=64)


def _both(formulation, **kw):
    jcfg, tcfg = _cfgs(formulation, **kw)
    jstate, tstate = _toy_state(formulation)
    return (JEx.from_state(jcfg, jstate, JSC(**SERVING)),
            TEx.from_state(tcfg, tstate, TSC(**SERVING), device="cpu"))


@pytest.mark.parametrize("formulation,rescore,estep", [
    ("augmented", "sparse", "packed"),
    ("augmented", "sparse", "dense"),
    ("augmented", "dense", "packed"),
    ("augmented", "dense", "dense"),
    ("standard", "sparse", "packed"),
    ("augmented", "fused", "packed"),
])
def test_extractor_matches_jax(formulation, rescore, estep):
    jex, tex = _both(formulation, rescore=rescore, estep=estep)
    utts = _requests()
    want, jinfo = jex.extract(utts, return_info=True)
    got, tinfo = tex.extract(utts, return_info=True)
    assert got.shape == (len(utts), R)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert tex.stats == jex.stats
    assert tex.buckets() == jex.buckets() and len(tex.buckets()) >= 3
    assert [vars(i) for i in tinfo] == [vars(i) for i in jinfo]
    assert tinfo[7].truncated and tinfo[-1].empty
    assert not got[-1].any()
    np.testing.assert_allclose(np.linalg.norm(got[:-1], axis=1), 1.0,
                               rtol=1e-5)


def test_demotion_through_chaos_hook_matches_jax():
    """A failing sparse kernel demotes the session to dense, counted, and
    it keeps serving the same i-vectors as JAX's demoted session."""
    jex, tex = _both("augmented")
    jex._chaos_fail_modes.add("sparse")
    tex._chaos_fail_modes.add("sparse")
    utts = _requests(1)
    want = jex.extract(utts)
    got = tex.extract(utts)
    assert tex.mode == "dense" and tex.stats["degradations"] == 1
    assert tex.stats == jex.stats
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    tex._chaos_fail_modes.add("dense")
    with pytest.raises(RuntimeError, match="chaos"):
        tex.extract(utts[:1])


def test_fused_session_demotes_down_the_ladder_like_jax():
    """A fused session starts on 'fused'; failing fused and sparse kernels
    demote it to dense, two steps counted, serving what JAX's demoted
    session serves."""
    jex, tex = _both("augmented", rescore="fused")
    assert tex.mode == "fused" and tex.health_check()["mode"] == "fused"
    for ex in (jex, tex):
        ex._chaos_fail_modes.update({"fused", "sparse"})
    utts = _requests(2)
    want = jex.extract(utts)
    got = tex.extract(utts)
    assert tex.mode == "dense" and tex.stats["degradations"] == 2
    assert tex.stats == jex.stats
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_health_check_restores_request_counters():
    _, tex = _both("augmented")
    h = tex.health_check()
    assert h["ok"] and h["mode"] == "sparse" and h["error"] is None
    assert h["canary_norm"] == pytest.approx(1.0, rel=1e-5)
    assert tex.stats["requests"] == 0 and tex.stats["batches"] == 0


def test_port_imports_neither_jax_nor_repro():
    """Importing every module of repro_torch pulls in no JAX and nothing
    of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "need = ['serving.session', 'serving.guard', 'serving.rollout',\n"
        "        'launch.serve_ivector', 'core.guardrails',\n"
        "        'distributed.fault_tolerance', 'launch.mesh',\n"
        "        'launch.ivector_cell']\n"
        "missing = [m for m in need if 'repro_torch.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code],
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
