"""The port's mesh of ranks (``launch/mesh.py``, the engine's mesh mode,
``launch/ivector_cell.py``) on the CPU over gloo, against its own one-rank
run and against the JAX package.

Multi-rank runs are spawned by ``launch.mesh.run_ranks`` (a file store in
``tmp_path``, a time limit on every join) in three worlds, all at once:
2 ranks for the (2, 1) trajectory and the (2, 1) and (1, 2) per-utterance
stats, 2 for the (2, 1) supervised run and fused trajectory, 4 for
(4, 1) and (2, 2). The JAX reference runs at the same time in one
subprocess with ``fake_device_env(4)``. Each world, and the JAX run, has
a fixture of its own, so a world that overruns its deadline errors only
the tests that read it, and names the phases its ranks reached. Sizes are
the JAX mesh tests' (``tests/test_mesh_trainer.py``): D 8, C 16, R 12,
K 8, 48 utterances x 40 frames.

- (2, 1) and (4, 1) with ``exit_reduce='ordered'`` and one chunk a rank
  reproduce the one-rank trajectory bit for bit, realignment with the
  full UBM refresh included: T, Σ, UBM means, i-vectors, EER.
- Per-utterance n/f are bitwise the one-rank pass's on every mesh.
- ``train_supervised`` on (2, 1) restarts bitwise at the one-rank
  trajectory, also when rank 1 arrives after rank 0 could have saved.
- ``sharded_align_stats`` on (2, 2) equals JAX's on a (2, 2) mesh within
  1e-4 on every rung; the fused (2, 1) trajectory tracks JAX's within the
  tolerances of ``test_sharded_trajectory_fused_matches_dense_8dev``.
- One process: ``resolve_mesh``'s errors, the one-rank default, the
  prefetch iterator, macro-batches, resume, the recipe's provenance.
"""
import os
import subprocess
import sys
import textwrap
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import recipe as JRC  # noqa: E402
from repro.configs.ivector_tvm import SMOKE as J_SMOKE  # noqa: E402
from repro.core import engine as JEN  # noqa: E402
from repro.core import tvm as JTV  # noqa: E402
from repro.data.speech import SpeechDataConfig  # noqa: E402
from repro.launch import ivector_cell as JIC  # noqa: E402
from repro.launch import mesh as JMS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import IVectorRecipe, peek  # noqa: E402
from repro_torch.core import engine as EN  # noqa: E402
from repro_torch.core import trainer as TR  # noqa: E402
from repro_torch.core import tvm as TV  # noqa: E402
from repro_torch.core import ubm as U  # noqa: E402
from repro_torch.data import speech as DS  # noqa: E402
from repro_torch.launch import ivector_cell as IC  # noqa: E402
from repro_torch.launch import mesh as MS  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_ranks as RK  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CFG = RK.CFG
DATA = SpeechDataConfig(feat_dim=8, n_components=8, n_speakers=12,
                        utts_per_speaker=4, frames_per_utt=40,
                        speaker_rank=6, channel_rank=3,
                        speaker_scale=0.8, channel_scale=0.8)
# seconds from the launch within which each spawned world and the JAX
# subprocess end: at least 3x the slowest wall read under the full suite's
# load (-n 6), where the three worlds took up to 28 s and the JAX run 73 s
DEADLINE = {"trajectory2": 240, "supervised2": 240, "world4": 240,
            "jax": 300}
# torch's host threads in each of the eight ranks the three worlds run at
# once, and in this process: the cores shared out, and one count
# everywhere, so that a reduction sums in the same order in a rank as in
# the one-rank run it is held to bit for bit
THREADS = max(1, (os.cpu_count() or 1) // 8)

JAX_SCRIPT = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.ivector_tvm import SMOKE
from repro.core import trainer as TR, ubm as U
from repro.launch import ivector_cell as IC
from repro.launch.mesh import make_local_mesh
z = np.load(sys.argv[1])
feats = jnp.asarray(z["feats"])
ubm = U.FullGMM(jnp.asarray(z["w"]), jnp.asarray(z["means"]),
                jnp.asarray(z["covs"]))
cfg = SMOKE.with_overrides(feat_dim=8, n_components=16, ivector_dim=12,
                           posterior_top_k=8, lda_dim=8, n_iters=3,
                           update_sigma=True)
out = {}
pre = U.full_precisions(ubm)
mesh = make_local_mesh(2, 2)
for r in ("fused", "sparse", "dense"):
    n, f, S = IC.sharded_align_stats(cfg.with_overrides(rescore=r), mesh,
                                     ubm.to_diag(), pre, feats, True)
    out[f"align_{r}_n"] = np.asarray(n)
    out[f"align_{r}_f"] = np.asarray(f)
    out[f"align_{r}_S"] = np.asarray(S)
fcfg = cfg.with_overrides(rescore="fused", estep_chunk=feats.shape[0] // 2)
st = TR.train(fcfg, ubm, feats, key=jax.random.PRNGKey(100), mesh=(2, 1))
out["fused_T"] = np.asarray(st.model.T)
out["fused_Sigma"] = np.asarray(st.model.Sigma)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def corpus():
    """48 utterances from the JAX tests' data config (the port's
    generator), a UBM the port trains on them, and JAX's T draw from
    PRNGKey(100), as numpy."""
    feats, labels = DS.build_dataset(DS.SpeechDataConfig(**vars(DATA)),
                                     device="cpu")
    feats = feats.numpy()
    gmm = U.train_ubm(torch.tensor(feats.reshape(-1, 8)), 16,
                      torch.Generator().manual_seed(0), device="cpu")
    w, means, covs = (gmm.weights.numpy(), gmm.means.numpy(),
                      gmm.covs.numpy())
    m0 = JTV.init_model(jax.random.PRNGKey(RK.SEED), jnp.asarray(means),
                        jnp.asarray(covs), CFG.ivector_dim, CFG.formulation,
                        CFG.prior_offset)
    return {"feats": feats, "labels": np.asarray(labels), "w": w,
            "means": means, "covs": covs, "T0": np.asarray(m0.T),
            "prior0": np.asarray(m0.prior)}


@pytest.fixture(scope="module")
def launched(corpus, tmp_path_factory):
    """The JAX subprocess and the three spawned worlds, started at once;
    the fixtures below each wait for one of them."""
    d = tmp_path_factory.mktemp("mesh")
    path = d / "inputs.npz"
    np.savez(path, **corpus)
    env = JMS.fake_device_env(4)
    # one thread for XLA's CPU ops: the subprocess runs beside eight ranks,
    # each capped by run_ranks to its share of the cores
    env["XLA_FLAGS"] += " --xla_cpu_multi_thread_eigen=false"
    env["PYTHONPATH"] = str(REPO / "src")
    env["JAX_PLATFORMS"] = "cpu"
    t0 = time.monotonic()
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT), str(path),
         str(d / "jax_out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    walls = {}
    pool = ThreadPoolExecutor(3)
    worlds = {}
    for name, fn, n, args in (
            ("trajectory2", RK.world2_trajectory, 2, (str(path),)),
            ("supervised2", RK.world2_supervised, 2,
             (str(path), str(d / "ckpt"))),
            ("world4", RK.world4, 4, (str(path),))):
        worlds[name] = pool.submit(MS.run_ranks, fn, n, args=args,
                                   device="cpu", timeout=DEADLINE[name],
                                   workdir=d, threads=THREADS)
        worlds[name].add_done_callback(
            lambda f, name=name: walls.setdefault(name,
                                                  time.monotonic() - t0))
    yield {"dir": d, "t0": t0, "worlds": worlds, "jax": jax_proc,
           "walls": walls}
    pool.shutdown(wait=True)
    if jax_proc.poll() is None:
        jax_proc.kill()
        jax_proc.communicate()


def _world(launched, name):
    """The per-rank results of one world; past its deadline, the error
    names the phases its ranks reached and the walls (s from the launch)
    of the worlds that had ended."""
    try:
        return launched["worlds"][name].result()
    except TimeoutError as e:
        raise TimeoutError(f"{e}; phases reached by pid: "
                           f"{RK.progress(launched['dir'], name)}; walls of "
                           f"the ended: {launched['walls']}") from e


@pytest.fixture(scope="module")
def trajectory2(launched):
    return _world(launched, "trajectory2")


@pytest.fixture(scope="module")
def supervised2(launched):
    return _world(launched, "supervised2")


@pytest.fixture(scope="module")
def world4(launched):
    return _world(launched, "world4")


@pytest.fixture(scope="module")
def jax_out(launched):
    """The JAX subprocess's arrays."""
    proc = launched["jax"]
    left = launched["t0"] + DEADLINE["jax"] - time.monotonic()
    _, err = proc.communicate(timeout=max(left, 1.0))
    launched["walls"]["jax"] = time.monotonic() - launched["t0"]
    assert proc.returncode == 0, err[-3000:]
    return dict(np.load(launched["dir"] / "jax_out.npz"))


def _port_ubm(corpus):
    return convert.ubm_from_numpy(corpus["w"], corpus["means"],
                                  corpus["covs"], device="cpu")


@pytest.fixture(scope="module")
def one_rank(corpus):
    """The one-rank runs each mesh is held to, in this process."""
    feats = torch.tensor(corpus["feats"])
    ubm = _port_ubm(corpus)
    out = {}
    for extent in (2, 4):
        out[f"train_{extent}"] = RK.train_and_extract(
            RK.bitwise_cfg(extent, feats.shape[0]), ubm, feats,
            corpus["labels"], None)
    out["nf"] = RK.nf(ubm, feats, MS.make_local_mesh(device="cpu"))
    out["nf_tied"] = RK.nf(RK.tied(ubm), feats,
                           MS.make_local_mesh(device="cpu"))
    return out


# ---------------------------------------------------------------------------
# Spawned ranks against the one-rank run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 1), (4, 1)])
def test_data_mesh_trajectory_is_bitwise_one_rank(request, one_rank, shape):
    """The ordered exit fold with one chunk a rank: T, Σ, the UBM means
    after the full refresh, the i-vectors and the EER are the one-rank
    run's bit for bit, on every rank."""
    world = request.getfixturevalue("trajectory2" if shape == (2, 1)
                                    else "world4")
    name = f"train_{shape[0]}x{shape[1]}"
    want = one_rank[f"train_{shape[0]}"]
    for rank_out in world:
        got = rank_out[name]
        for k in ("T", "Sigma", "means", "iv"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["eer"] == want["eer"]


@pytest.mark.parametrize("name", ["nf_2x1", "nf_1x2", "nf_4x1", "nf_2x2",
                                  "nf_tied_1x2"])
def test_per_utterance_stats_bitwise_across_meshes(request, one_rank,
                                                   name):
    """Per-utterance sums never cross ranks, and the two-stage top-K
    breaks ties toward the lowest global id as one rank does (the tied
    UBM repeats its first half of components in its second, so every
    diag score ties across the two model ranks)."""
    world = request.getfixturevalue(
        "trajectory2" if name in ("nf_2x1", "nf_1x2", "nf_tied_1x2")
        else "world4")
    want = one_rank["nf_tied" if "tied" in name else "nf"]
    for rank_out in world:
        np.testing.assert_array_equal(rank_out[name]["n"], want["n"])
        np.testing.assert_array_equal(rank_out[name]["f"], want["f"])


def test_supervised_resume_on_a_mesh_is_bitwise(supervised2, one_rank):
    """train_supervised on (2, 1) with a failure injected after step 1:
    rank 0 writes the checkpoints, both ranks restart from them, and the
    run ends bitwise at the one-rank trajectory."""
    want = one_rank["train_2"]
    for rank_out in supervised2:
        got = rank_out["supervised_2x1"]
        assert got["restarts"] == 1 and got["iteration"] == CFG.n_iters
        np.testing.assert_array_equal(got["T"], want["T"])
        np.testing.assert_array_equal(got["Sigma"], want["Sigma"])


def test_supervised_start_agrees_when_a_rank_is_late(corpus, one_rank,
                                                     tmp_path):
    """Rank 1 reaches ``train_supervised`` 3 s after rank 0, which has by
    then written its step-0 checkpoint if nothing holds it: both ranks
    still start from scratch, restart once after the injected failure and
    end bitwise at the one-rank trajectory. (A rank that saw rank 0's
    checkpoint would restore and enter the first step's collectives while
    rank 0 waited in the save's barrier: the deadlock that timed the
    supervised world out under load.)"""
    path = tmp_path / "inputs.npz"
    np.savez(path, **corpus)
    out = MS.run_ranks(RK.late_supervised, 2,
                       args=(str(path), str(tmp_path / "ckpt"), 3.0),
                       device="cpu", timeout=DEADLINE["supervised2"],
                       workdir=tmp_path, threads=THREADS)
    want = one_rank["train_2"]
    for got in out:
        assert got["restarts"] == 1 and got["iteration"] == CFG.n_iters
        np.testing.assert_array_equal(got["T"], want["T"])
        np.testing.assert_array_equal(got["Sigma"], want["Sigma"])


def test_collectives_are_counted(trajectory2):
    """A data mesh moves bytes only at the exit reduce and when it hands
    per-utterance statistics back; no model-axis collective runs."""
    comm = trajectory2[0]["comm"]
    assert comm["exit"][0] > 0 and comm["exit"][1] > 0
    assert comm["gather"][1] > 0
    assert "model" not in comm


# ---------------------------------------------------------------------------
# Spawned ranks against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rescore", ["fused", "sparse", "dense"])
def test_sharded_align_stats_match_jax(world4, jax_out, rescore):
    """(2, 2): the port's n, f and S equal the JAX package's on the same
    numpy inputs within rtol = atol = 1e-4, on every rank."""
    jx = jax_out
    for rank_out in world4:
        got = rank_out[f"align_{rescore}"]
        for k in ("n", "f", "S"):
            np.testing.assert_allclose(got[k], jx[f"align_{rescore}_{k}"],
                                       rtol=1e-4, atol=1e-4, err_msg=k)


def test_rungs_agree_on_the_model_sharded_mesh(world4):
    """``sharded_align_stats`` on (2, 2): the sparse and fused rungs agree
    with the dense rung within 1e-4 (``test_sharded_sparse_rescore_
    matches_dense``)."""
    got = world4[0]
    for r in ("sparse", "fused"):
        for k in ("n", "f", "S"):
            np.testing.assert_allclose(got[f"align_{r}"][k],
                                       got["align_dense"][k],
                                       rtol=1e-4, atol=1e-4)


def test_fused_trajectory_tracks_jax(supervised2, jax_out):
    """The fused rung on (2, 1), 3 iterations from the same T0: T Tᵀ and Σ
    within the tolerances of JAX's
    ``test_sharded_trajectory_fused_matches_dense_8dev``."""
    got, jx = supervised2[0]["fused_2x1"], jax_out

    def TTt(T):
        return np.einsum("cdr,cer->cde", T, T)
    np.testing.assert_allclose(TTt(got["T"]), TTt(jx["fused_T"]),
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(got["Sigma"], jx["fused_Sigma"],
                               rtol=1e-3, atol=1e-4)


def test_em_macro_step_matches_one_rank(world4, corpus):
    """``em_macro_step`` on (2, 2) with the 'psum' exit: the packed A, B, h
    and S agree with the one-rank step within f32 reassociation."""
    feats = torch.tensor(corpus["feats"])
    ubm = _port_ubm(corpus)
    acc, S = IC.em_macro_step(
        CFG.with_overrides(estep="packed"), MS.make_local_mesh(device="cpu"),
        ubm.weights, ubm.means, ubm.covs, torch.tensor(corpus["T0"]),
        ubm.covs, torch.tensor(corpus["prior0"]), feats, utt_chunk=6)
    got = world4[0]["macro_2x2"]
    for k, want in (("A", acc.A), ("B", acc.B), ("h", acc.h), ("S", S)):
        want = want.numpy()
        np.testing.assert_allclose(got[k], want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# run_ranks and the backend
# ---------------------------------------------------------------------------


def test_run_ranks_raises_with_the_failing_ranks_traceback(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        MS.run_ranks(RK.failing, 2, device="cpu", timeout=60,
                     workdir=tmp_path)


def test_run_ranks_stops_a_stalled_world(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="within 8"):
        MS.run_ranks(RK.stalled, 2, device="cpu", timeout=8,
                     workdir=tmp_path)
    assert time.monotonic() - t0 < 30


@pytest.mark.parametrize("backend,devices", [
    ("nccl", ["cuda:0", "cuda:0"]), ("nccl", ["cpu", "cpu"]),
    ("mpi", ["cpu", "cpu"])])
def test_backend_refusals(backend, devices):
    """NCCL on a shared card (or on the CPU) raises and names gloo; no
    backend is swapped in behind the caller's back."""
    match = "backend='gloo'" if backend == "nccl" else "'nccl' or 'gloo'"
    with pytest.raises(ValueError, match=match):
        MS.check_backend(backend, devices)
    MS.check_backend("gloo", devices if backend != "mpi" else ["cpu"])


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------


def _fake_mesh(shape):
    """A Mesh with extents and no process groups: enough for the checks
    that run before any collective."""
    return MS.Mesh(MS.AXES, shape, (0, 0), torch.device("cpu"))


@pytest.mark.parametrize("args,exc,msg", [
    (((2,),), ValueError, "mesh tuple must be (data, model), got (2,)"),
    (("2x1",), TypeError,
     "mesh must be a Mesh, (data, model) tuple or None, got"),
    ((_fake_mesh((2, 1)), 3), ValueError,
     "3 utterances do not divide the mesh's data extent 2 "
     "({'data': 2, 'model': 1})"),
    ((_fake_mesh((1, 2)), 4, 15), ValueError,
     "15 components do not divide the mesh's model extent 2")])
def test_resolve_mesh_errors(args, exc, msg):
    """The reference's messages (``repro/launch/mesh.py:84-113``); the
    first is checked against JAX's own raise."""
    with pytest.raises(exc) as e:
        MS.resolve_mesh(*args)
    assert msg in str(e.value)
    if args == ((2,),):
        with pytest.raises(exc) as j:
            JMS.resolve_mesh(*args)
        assert str(j.value) == str(e.value)


def test_a_mesh_needs_its_ranks():
    with pytest.raises(RuntimeError, match="run_ranks"):
        MS.make_local_mesh(2, 1, device="cpu")
    one = MS.make_local_mesh(device="cpu")
    assert (one.size, one.rank, one.data_rank, one.model_rank) == (1, 0, 0,
                                                                   0)
    assert MS.mesh_descriptor(one) == JMS.mesh_descriptor(
        JMS.make_local_mesh(1, 1))
    assert MS.mesh_descriptor(None) is None


def test_config_mesh_knob_validation():
    good = CFG.with_overrides(mesh=(2, 1))
    assert good.mesh == (2, 1)
    assert CFG.with_overrides(mesh=[4, 2]).mesh == (4, 2)
    for bad in ((0, 2), (2,), (2, 3)):
        with pytest.raises(ValueError):
            CFG.with_overrides(mesh=bad)


def test_exit_reduce_message_is_the_reference_s():
    spec = EN.EngineSpec(n_components=16, top_k=8, floor=0.025)
    with pytest.raises(ValueError) as e:
        EN._stream_sharded(spec, None, None, None, (), False,
                           _fake_mesh((2, 1)), exit_reduce="bogus")
    with pytest.raises(ValueError) as j:
        JEN._stream_sharded(spec, None, None, None, (), False, None,
                            exit_reduce="bogus")
    assert str(e.value) == str(j.value)


def test_topk_lowest_breaks_ties_toward_the_lowest_position():
    from repro_torch.kernels import ref
    v = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 1.0]])
    assert ref.topk_lowest(v, 3).tolist() == [[1, 2, 4], [4, 0, 1]]
    jv = np.asarray(jax.lax.top_k(jnp.asarray(v.numpy()), 3)[1])
    assert ref.topk_lowest(v, 3).tolist() == jv.tolist()


def test_one_rank_default_is_the_local_path(corpus):
    """train() with no mesh, with (1, 1) and with an explicit one-rank
    Mesh: bitwise the same; and ``engine.stream`` on a one-rank mesh is
    ``mesh=None``."""
    feats = torch.tensor(corpus["feats"])
    ubm = _port_ubm(corpus)
    cfg = CFG.with_overrides(n_iters=2)

    def run(**kw):
        return TR.train(cfg, ubm, feats, generator=torch.Generator()
                        .manual_seed(3), device="cpu", **kw)
    a, b = run(), run(mesh=(1, 1))
    c = run(mesh=MS.make_local_mesh(1, 1, device="cpu"))
    for s in (b, c):
        assert torch.equal(a.model.T, s.model.T)
        assert torch.equal(a.model.Sigma, s.model.Sigma)
        assert torch.equal(a.ubm.means, s.ubm.means)
    spec = TR._spec(cfg, True)
    pack = EN.pack_ubm(ubm, "cpu")
    x, y = (EN.stream_bw(spec, pack, feats, mesh=m)
            for m in (None, MS.make_local_mesh(device="cpu")))
    assert torch.equal(x[0].n, y[0].n) and torch.equal(x[0].S, y[0].S)


@pytest.mark.parametrize("size", [0, 1, 3])
def test_prefetch_matches_plain_iterator(corpus, size):
    """prefetch_to_device == iter_batches element for element, with and
    without a mask (on the CPU the batches pass through)."""
    feats = torch.tensor(corpus["feats"])
    mask = torch.ones(feats.shape[:2])
    for m in (None, mask):
        plain = list(DS.iter_batches(feats, m, 16))
        pre = list(DS.prefetch_to_device(DS.iter_batches(feats, m, 16),
                                         size=size))
        assert len(plain) == len(pre) == 3
        for (fa, ma), (fb, mb) in zip(plain, pre):
            assert torch.equal(fa, fb)
            assert (ma is None) == (mb is None)
            if ma is not None:
                assert torch.equal(ma, mb)
    assert len(list(DS.iter_batches(feats, None, 0))) == 1


def test_macro_batched_pass_is_bitwise_the_resident_one(corpus):
    """Partials of 12-utterance macro-batches merged in order equal one
    resident pass with 12-utterance chunks, bit for bit; and
    ``train(macro_batch=12)`` equals ``train`` with ``estep_chunk=12``.
    (The reference holds its macro-batched accumulators to 1e-5: it
    reduces every macro-batch, in another association.)"""
    feats = torch.tensor(corpus["feats"])
    ubm = _port_ubm(corpus)
    cfg = CFG.with_overrides(estep_chunk=12, n_iters=2)
    model = TV.init_model(torch.Generator().manual_seed(3), ubm.means,
                          ubm.covs, cfg.ivector_dim, cfg.formulation,
                          cfg.prior_offset)
    spec = TR._spec(cfg, True)
    pack = EN.pack_ubm(ubm, "cpu")
    accums = TR._iter_accums(cfg, spec, model, 8)
    parts = None
    for fb, mb in DS.prefetch_to_device(DS.iter_batches(feats, None, 12)):
        p, _ = EN.stream_partial(spec, pack, fb, mb, accums)
        parts = p if parts is None else (TR.merge_totals(parts[0], p[0]),
                                         TV.merge_accums(parts[1], p[1]))
    (tot, acc), _ = EN.stream(spec, pack, feats, None, accums)
    for a, b in zip(parts[0] + parts[1], tot + acc):
        assert torch.equal(a, b)
    gen = torch.Generator
    a = TR.train(cfg, ubm, feats, generator=gen().manual_seed(3),
                 device="cpu")
    b = TR.train(cfg, ubm, feats, generator=gen().manual_seed(3),
                 device="cpu", macro_batch=12, prefetch=2)
    assert torch.equal(a.model.T, b.model.T)
    assert torch.equal(a.model.Sigma, b.model.Sigma)


def test_resume_after_injected_failure_bit_exact(corpus, tmp_path):
    """An injected failure costs one macro-step: the supervised run ends
    bitwise at the uninterrupted ``train`` (realignment and the full UBM
    refresh on)."""
    feats = torch.tensor(corpus["feats"])
    ubm = _port_ubm(corpus)
    gen = torch.Generator
    ref = TR.train(CFG, ubm, feats, generator=gen().manual_seed(5),
                   device="cpu")
    st, rep = TR.train_supervised(
        CFG, ubm, feats, generator=gen().manual_seed(5),
        ckpt_dir=tmp_path / "ckpt", device="cpu", mesh=(1, 1),
        fail_at=lambda step, attempt: step == 1 and attempt == 0)
    assert rep.n_restarts == 1 and st.iteration == CFG.n_iters
    assert torch.equal(st.model.T, ref.model.T)
    assert torch.equal(st.model.Sigma, ref.model.Sigma)
    assert torch.equal(st.ubm.means, ref.ubm.means)


def test_recipe_mesh_provenance_and_bundle_strip(corpus, tmp_path):
    """recipe.run(mesh=(1, 1)) == recipe.run(); provenance records the
    JAX package's descriptor, and the saved bundle's config has no mesh."""
    feats = torch.tensor(corpus["feats"])
    triple = (feats, corpus["labels"], _port_ubm(corpus))
    cfg = CFG.with_overrides(n_iters=2)
    recipe = IVectorRecipe.from_config(cfg, device="cpu")
    ref = recipe.run(data=triple, seed=0)
    got = recipe.run(data=triple, seed=0, mesh=(1, 1),
                     bundle_dir=tmp_path / "bundle")
    assert got.eer == ref.eer
    np.testing.assert_array_equal(got.ivectors, ref.ivectors)

    class Ctx:
        feats = corpus["feats"]
        cfg = J_SMOKE.with_overrides(n_components=16)
    want = JRC._mesh_provenance((1, 1), Ctx)
    assert got.provenance["mesh"] == want == [["data", 1], ["model", 1]]
    assert ref.provenance["mesh"] == want
    meta = peek(got.bundle_path)
    assert meta["config"].get("mesh") is None
    assert meta["provenance"]["mesh"] == want


def test_ivector_cell_counts_and_inputs_match_jax():
    """``input_structs`` has the reference's shapes (as meta tensors) and
    ``model_flops`` its count on the rungs whose count does not come from
    the TPU autotuner."""
    from repro.configs.ivector_tvm import CONFIG as J_CONFIG
    from repro_torch.configs.ivector_tvm import CONFIG
    got, want = IC.input_structs(CONFIG), JIC.input_structs(J_CONFIG, None)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert all(v.device.type == "meta" for v in got.values())
    assert IC.input_axes() == JIC.input_axes()
    for over in ({"rescore": "dense"}, {"rescore": "sparse"},
                 {"rescore": "sparse", "estep": "packed"}):
        assert IC.model_flops(CONFIG.with_overrides(**over), 8192) == \
            JIC.model_flops(J_CONFIG.with_overrides(**over), 8192)


def test_checkpoint_elastic_knobs_still_refuse(tmp_path):
    """The elastic knobs no longer refuse: rules of one rank restore what a
    manager with logical axes saved, whole, as the reference does without
    a mesh (the re-mesh itself: tests/test_torch_mesh_lm.py)."""
    from repro_torch.checkpoint import manager as CM
    from repro_torch.sharding import make_rules
    one = make_rules(MS.Mesh(("data", "model"), (1, 1), (0, 0),
                             torch.device("cpu")))
    tree = {"w": torch.arange(8.0).reshape(4, 2)}
    mgr = CM.CheckpointManager(tmp_path, logical_axes={"w": ("batch", None)},
                               rules=one, device="cpu")
    mgr.maybe_save(3, tree, force=True)
    got, step, _ = mgr.restore_latest(tree)
    assert step == 3 and torch.equal(got["w"], tree["w"])
