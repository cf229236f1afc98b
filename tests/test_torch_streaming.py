"""Parity of the PyTorch port's streaming sessions, admission queue and
rollout with the JAX package's, on the CPU.

A toy JAX model (the state of ``tests/test_streaming.py``) is carried
across with ``repro_torch.convert``; each scenario runs through both
packages on the same chunks and, where it has a clock, the same injected
clock. The write-ahead journal is held byte for byte: one record encodes
to the same bytes in both, and a WAL either package wrote restores in the
other with bitwise ``n`` and ``f``. I-vectors are held within ``TOL`` =
1e-5 absolute (the tolerance of ``tests/test_torch_serving.py``: the same
f32 statistics summed in another order, through a Cholesky); counters,
flags and outcomes must be equal.
"""
import dataclasses
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving as JS  # noqa: E402
import repro_torch.serving as TS  # noqa: E402
from repro.api.bundle import Bundle as JBundle  # noqa: E402
from repro.configs.ivector_tvm import SMOKE as J_SMOKE  # noqa: E402
from repro.core import tvm as JTV  # noqa: E402
from repro.core import ubm as JU  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api.bundle import Bundle as TBundle  # noqa: E402
from repro_torch.configs.ivector_tvm import SMOKE as T_SMOKE  # noqa: E402
from repro_torch.launch import serve_ivector  # noqa: E402

KEY = jax.random.PRNGKey(7)
C, D, R = 8, 5, 6
TOL = 1e-5


def _pkg(mod, bundle, smoke, jax_side):
    return SimpleNamespace(
        jax=jax_side, Bundle=bundle, SMOKE=smoke,
        **{k: getattr(mod, k) for k in mod.__all__})


J = _pkg(JS, JBundle, J_SMOKE, True)
T = _pkg(TS, TBundle, T_SMOKE, False)
BOTH = (J, T)


@pytest.fixture(scope="module")
def toy():
    """The JAX toy UBM and one T per formulation, as numpy."""
    key = jax.random.fold_in(KEY, 40)
    means = jax.random.normal(key, (C, D)) * 2
    A = jax.random.normal(jax.random.fold_in(key, 1), (C, D, D)) * 0.2
    covs = jnp.einsum("cij,ckj->cik", A, A) + jnp.eye(D)
    ubm = JU.FullGMM(jnp.ones((C,)) / C, means, covs)
    models = {f: JTV.init_model(jax.random.fold_in(KEY, 41), ubm.means,
                                ubm.covs, R, f, prior_offset=10.0)
              for f in ("standard", "augmented")}
    return ubm, models


def _ex(P, toy, formulation="augmented", rescore="sparse", serving=None,
        T_scale=1.0):
    """Either package's extractor on the toy state (the port's on the
    CPU). ``rescore='sparse'`` leaves exactly one ladder step."""
    ubm, models = toy
    m = models[formulation]
    cfg = P.SMOKE.with_overrides(feat_dim=D, n_components=C, ivector_dim=R,
                                 posterior_top_k=4, formulation=formulation,
                                 rescore=rescore)
    sv = P.ServingConfig(**(serving or dict(min_bucket=16, max_bucket=128)))
    if P.jax:
        return P.IVectorExtractor(
            cfg, dataclasses.replace(m, T=m.T * T_scale), ubm, sv)
    tubm = convert.ubm_from_numpy(
        *(np.asarray(a) for a in (ubm.weights, ubm.means, ubm.covs)),
        device="cpu")
    tm = convert.tvm_from_numpy(np.asarray(m.T) * np.float32(T_scale),
                                *(np.asarray(a) for a in (m.Sigma, m.prior,
                                                          m.means)),
                                formulation, device="cpu")
    return P.IVectorExtractor(cfg, tm, tubm, sv, device="cpu")


def _scfg(P, **kw):
    kw.setdefault("chunk_min_bucket", 16)
    kw.setdefault("chunk_max_bucket", 64)
    return P.SessionConfig(**kw)


def _chunk(seed, F=20):
    return np.random.RandomState(seed).randn(F, D).astype(np.float32)


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _feed(store, rounds=3, sids=("s0", "s1", "s2")):
    for r in range(rounds):
        for i, sid in enumerate(sids):
            store.update(sid, _chunk(10 * r + i, 12 + 7 * i), emit=False)


def _assert_sessions_equal(a, b, sids):
    for sid in sids:
        x, y = a.session(sid), b.session(sid)
        np.testing.assert_array_equal(x.n, y.n)
        np.testing.assert_array_equal(x.f, y.f)
        assert (x.seq, x.chunks, x.frames, x.loglik, x.created) == \
            (y.seq, y.chunks, y.frames, y.loglik, y.created)


# ---------------------------------------------------------------------------
# The journal, byte for byte
# ---------------------------------------------------------------------------


def test_journal_record_encodes_to_the_same_bytes(tmp_path):
    rng = np.random.default_rng(0)
    rec = {"kind": "update", "sid": "stream-3", "seq": 4, "chunks": 4,
           "frames": 77.0, "loglik": -123.456789, "created": 12.5,
           "n": rng.random(C, dtype=np.float32),
           "f": rng.standard_normal((C, D)).astype(np.float32)}
    jj = J.SessionJournal(tmp_path / "a", C, D)
    tj = T.SessionJournal(tmp_path / "b", C, D)
    want = jj._frame(jj._encode(rec))
    assert tj._frame(tj._encode(rec)) == want
    for r in ({"kind": "close", "sid": "stream-3"},
              {"kind": "header", "version": 1, "C": C, "D": D}):
        assert tj._frame(tj._encode(r)) == jj._frame(jj._encode(r))
    got = tj._decode(tj._encode(rec))
    np.testing.assert_array_equal(got["f"], rec["f"])


@pytest.mark.parametrize("writer,reader", [(J, T), (T, J)],
                         ids=["jax_to_torch", "torch_to_jax"])
def test_wal_restores_across_packages(toy, tmp_path, writer, reader):
    """A WAL one package wrote restores in the other: n, f bitwise, the
    session metadata and the restoring store's stats equal to the
    writer's own package restoring it; the next i-vector within TOL."""
    sids = ("s0", "s1", "s2")
    clock = Clock(5.0)
    w = writer.SessionStore(_ex(writer, toy), _scfg(
        writer, journal_dir=str(tmp_path / "w")), clock=clock)
    _feed(w, sids=sids + ("gone",))
    w.close("gone")
    for d in ("same", "other"):
        shutil.copytree(tmp_path / "w", tmp_path / d)
    same = writer.SessionStore(_ex(writer, toy), _scfg(
        writer, journal_dir=str(tmp_path / "same")), clock=clock)
    other = reader.SessionStore(_ex(reader, toy), _scfg(
        reader, journal_dir=str(tmp_path / "other")), clock=clock)
    assert "gone" not in other and other.stats["restored"] == len(sids)
    _assert_sessions_equal(other, w, sids)
    assert other.stats == same.stats
    iv_w, _ = w.update("s1", _chunk(99))
    iv_o, _ = other.update("s1", _chunk(99))
    np.testing.assert_allclose(iv_o, iv_w, rtol=TOL, atol=TOL)


def test_journal_header_mismatch_raises_in_both(tmp_path):
    j, _ = T.SessionJournal.open(tmp_path / "wal.log", C, D)
    j.close()
    for P in BOTH:
        with pytest.raises(ValueError, match="does not match"):
            P.SessionJournal.open(tmp_path / "wal.log", C + 1, D)


@pytest.mark.parametrize("cut", [10, 70, 300],
                         ids=["in_seal", "in_payload", "most_of_record"])
def test_torn_tail_truncates_to_the_same_end(toy, tmp_path, cut):
    store = T.SessionStore(_ex(T, toy), _scfg(
        T, journal_dir=str(tmp_path / "w")), clock=Clock())
    _feed(store, rounds=2)
    store.close_store()
    wal = tmp_path / "w" / "wal.log"
    size = wal.stat().st_size
    ends = []
    for P in BOTH:
        p = tmp_path / ("j" if P.jax else "t") / "wal.log"
        p.parent.mkdir()
        p.write_bytes(wal.read_bytes()[:size - cut])
        j, recs = P.SessionJournal.open(p, C, D)
        j.close()
        assert j.torn_tail
        ends.append((p.stat().st_size, len(recs), j.records))
    assert ends[0] == ends[1] and ends[0][0] < size - cut


# ---------------------------------------------------------------------------
# Sessions: incremental i-vectors against JAX and against batch extraction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("formulation", ["standard", "augmented"])
def test_session_ivectors_match_jax(toy, formulation):
    chunks = [_chunk(s, F) for s, F in [(0, 20), (1, 7), (2, 33), (3, 64)]]
    got = {}
    for P in BOTH:
        store = P.SessionStore(_ex(P, toy, formulation), _scfg(P))
        got[P.jax] = [store.update("s", ch)[0] for ch in chunks]
    for t, j in zip(got[False], got[True]):
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
    ex = _ex(T, toy, formulation)
    iv_batch = ex.extract([np.concatenate(chunks, 0)])[0]
    np.testing.assert_allclose(got[False][-1], iv_batch, rtol=1e-4,
                               atol=1e-4)


def test_session_emission_refines_over_chunks(toy):
    store = T.SessionStore(_ex(T, toy), _scfg(T))
    frames = []
    for s in range(4):
        iv, info = store.update("s", _chunk(s))
        assert np.isfinite(iv).all() and np.linalg.norm(iv) > 0
        assert info.seq == s + 1
        frames.append(store.session("s").frames)
    assert frames == sorted(frames) and frames[0] < frames[-1]


def _validation(P, toy):
    store = P.SessionStore(_ex(P, toy), _scfg(P))
    iv1, _ = store.update("s", _chunk(0))
    n_before = store.session("s").n.copy()
    bad = np.full((8, D), np.nan, np.float32)
    iv2, info = store.update("s", bad)
    assert info.empty and info.nonfinite_frames == 8
    np.testing.assert_array_equal(store.session("s").n, n_before)
    np.testing.assert_array_equal(iv1, iv2)   # same stats -> same solve
    half = _chunk(1, F=30)
    half[::3] = np.inf
    _, info2 = store.update("s", half)
    _, info3 = store.update("s", _chunk(1, F=500))
    assert info3.truncated and info3.n_frames == 64 and info3.bucket == 64
    return [vars(i) for i in (info, info2, info3)], store.stats


def test_session_chunk_validation_matches_jax(toy):
    assert _validation(T, toy) == _validation(J, toy)


def _ladder(P, toy):
    store = P.SessionStore(_ex(P, toy, rescore="fused"), _scfg(P))
    store._chaos_fail_modes = {"fused"}
    iv1, _ = store.update("s", _chunk(0))
    modes = [store._live.mode]
    store._chaos_fail_modes = {"fused", "sparse"}
    iv2, _ = store.update("s", _chunk(1))
    modes.append(store._live.mode)
    return modes, store.stats["degradations"], iv1, iv2


def test_session_degradation_ladder_matches_jax(toy):
    modes, degr, iv1, iv2 = _ladder(T, toy)
    assert modes == ["sparse", "dense"] and degr == 2
    jmodes, jdegr, jiv1, jiv2 = _ladder(J, toy)
    assert (modes, degr) == (jmodes, jdegr)
    np.testing.assert_allclose(iv1, jiv1, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(iv2, jiv2, rtol=TOL, atol=TOL)
    store = T.SessionStore(_ex(T, toy), _scfg(T))
    store._chaos_fail_modes = {"sparse", "dense"}
    with pytest.raises(RuntimeError, match="chaos"):
        store.update("s", _chunk(0))


def _ttl(P, toy):
    clock = Clock()
    store = P.SessionStore(_ex(P, toy), _scfg(P, ttl_s=10.0), clock=clock)
    store.update("a", _chunk(0))
    clock.t = 5.0
    store.update("b", _chunk(1))
    clock.t = 20.0
    store.update("c", _chunk(2))   # sweep runs on every update
    return [sid in store for sid in "abc"], store.stats


def test_session_ttl_eviction_matches_jax(toy):
    got = _ttl(T, toy)
    assert got[0] == [False, False, True] and got[1]["evicted_ttl"] == 2
    assert got == _ttl(J, toy)


def _lru(P, toy):
    budget = 2 * 4 * (C + C * D) + 1     # room for exactly 2 sessions
    store = P.SessionStore(_ex(P, toy), _scfg(P, max_bytes=budget))
    assert store.max_sessions == 2
    for sid, s in (("a", 0), ("b", 1), ("a", 2), ("c", 3)):
        store.update(sid, _chunk(s))
    h = store.health()
    assert h["used_bytes"] <= h["budget_bytes"]
    return [sid in store for sid in "abc"], h


def test_session_lru_eviction_matches_jax(toy):
    got = _lru(T, toy)
    assert got[0] == [True, False, True]
    assert got[1]["stats"]["evicted_lru"] == 1
    assert got == _lru(J, toy)


def test_session_journal_restore_bit_exact(toy, tmp_path):
    """Crash the store (no clean shutdown), rebuild from the journal: the
    bytes, the re-solve and the next chunk's emission are bitwise an
    uninterrupted store's."""
    ex = _ex(T, toy)
    cfg = _scfg(T, journal_dir=str(tmp_path / "j"))
    store = T.SessionStore(ex, cfg, clock=Clock())
    sids = ("s0", "s1", "s2")
    _feed(store, sids=sids)
    ref = {sid: store.solve(sid) for sid in sids}
    del store
    restored = T.SessionStore(ex, cfg, clock=Clock())
    straight = T.SessionStore(ex, _scfg(T), clock=Clock())
    _feed(straight, sids=sids)
    _assert_sessions_equal(restored, straight, sids)
    for i, sid in enumerate(sids):
        np.testing.assert_array_equal(restored.solve(sid), ref[sid])
        iv_r, _ = restored.update(sid, _chunk(99 + i))
        iv_s, _ = straight.update(sid, _chunk(99 + i))
        np.testing.assert_array_equal(iv_r, iv_s)


def test_session_journal_torn_tail_skipped(toy, tmp_path):
    ex = _ex(T, toy)
    cfg = _scfg(T, journal_dir=str(tmp_path))
    store = T.SessionStore(ex, cfg)
    ivs = [store.update("s", _chunk(i))[0] for i in range(3)]
    store.close_store()
    wal = tmp_path / "wal.log"
    with open(wal, "r+b") as fh:
        fh.truncate(wal.stat().st_size - 10)   # tear the 3rd record
    restored = T.SessionStore(ex, cfg)
    assert restored.stats["journal_torn"] == 1
    assert restored.session("s").chunks == 2
    np.testing.assert_array_equal(restored.solve("s"), ivs[1])
    restored.update("s", _chunk(7))            # append onto the healed log
    restored.close_store()
    again = T.SessionStore(ex, cfg)
    assert again.stats["journal_torn"] == 0
    assert again.session("s").chunks == 3


def _tombstone(P, toy, d):
    cfg = _scfg(P, journal_dir=str(d))
    store = P.SessionStore(_ex(P, toy), cfg)
    store.update("keep", _chunk(0))
    store.update("done", _chunk(1))
    assert store.close("done") is not None
    store.close_store()
    restored = P.SessionStore(_ex(P, toy), cfg)
    return ["keep" in restored, "done" in restored], restored.stats


def test_session_journal_close_tombstone_matches_jax(toy, tmp_path):
    got = _tombstone(T, toy, tmp_path / "t")
    assert got[0] == [True, False]
    assert got[0] == _tombstone(J, toy, tmp_path / "j")[0]


def _compaction(P, toy, d):
    cfg = _scfg(P, journal_dir=str(d), journal_compact_bytes=4096)
    store = P.SessionStore(_ex(P, toy), cfg)
    for i in range(24):                    # each record is a few hundred B
        store.update(f"s{i % 2}", _chunk(i))
    assert (d / "wal.log").stat().st_size <= 4096 + 1024
    ref = {sid: store.solve(sid) for sid in ("s0", "s1")}
    n_compactions = store.stats["compactions"]
    store.close_store()
    restored = P.SessionStore(_ex(P, toy), cfg)
    for sid in ("s0", "s1"):
        np.testing.assert_array_equal(restored.solve(sid), ref[sid])
        assert restored.session(sid).chunks == 12
    return n_compactions, restored.stats["journal_records"], ref


def test_session_journal_compaction_matches_jax(toy, tmp_path):
    n, records, ref = _compaction(T, toy, tmp_path / "t")
    jn, jrecords, jref = _compaction(J, toy, tmp_path / "j")
    assert n >= 1 and (n, records) == (jn, jrecords)
    for sid in ref:
        np.testing.assert_allclose(ref[sid], jref[sid], rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# Rollout
# ---------------------------------------------------------------------------


def _bundle_pair(P, toy, d):
    """The live extractor and two saved bundles: one of the same model,
    one with T x 1.01 (a new model)."""
    ex = _ex(P, toy)
    P.Bundle(cfg=ex.cfg, ubm=ex.ubm, model=ex.model).save(d / "b_same")
    new = _ex(P, toy, T_scale=1.01)
    P.Bundle(cfg=ex.cfg, ubm=ex.ubm, model=new.model).save(d / "b_new")
    return ex, d / "b_same", d / "b_new"


def _gate(P, toy, d):
    ex, p_same, _ = _bundle_pair(P, toy, d)
    rc = P.RolloutController(ex)
    rep = rc.roll(p_same, shadow_utts=[_chunk(i, 40) for i in range(3)])
    assert rc.live is not ex and rc.prev is ex
    assert rep.candidate_hash == rep.live_hash
    return rep.outcome, rep.parity["same_content"], rep.parity["bit_exact"]


def test_rollout_identical_bundle_gates_bit_exact(toy, tmp_path):
    got = _gate(T, toy, tmp_path / "t")
    assert got == ("swapped", True, True)
    assert got == _gate(J, toy, tmp_path / "j")


def test_rollout_hash_matches_jax_bundle(toy, tmp_path):
    """The port's model hash of a live extractor is the JAX bundle's
    content hash of the same arrays, so the gate sees a JAX-saved rebuild
    of the live model as the same content."""
    ex = _ex(T, toy)
    jex = _ex(J, toy)
    JBundle(cfg=jex.cfg, ubm=jex.ubm, model=jex.model).save(tmp_path / "b")
    rep = TS.RolloutController(ex).roll(tmp_path / "b",
                                        shadow_utts=[_chunk(0, 40)])
    assert rep.candidate_hash == rep.live_hash
    assert rep.outcome == "swapped" and rep.parity["bit_exact"]


def test_rollout_swap_and_rollback_bit_exact(toy, tmp_path):
    ex, _, p_new = _bundle_pair(T, toy, tmp_path)
    store = T.SessionStore(ex, _scfg(T))
    store.update("live-session", _chunk(0))
    rc = T.RolloutController(ex, store=store)
    utts = [_chunk(i, 40) for i in range(3)]
    before = ex.extract(utts)
    iv_sess_before = store.solve("live-session")
    rep = rc.roll(p_new, shadow_utts=utts, policy="migrate")
    assert rep.outcome == "swapped" and rep.sessions["migrated"] == 1
    assert not np.array_equal(before, rc.live.extract(utts))
    assert np.isfinite(store.solve("live-session")).all()
    assert rc.rollback() and rc.live is ex
    np.testing.assert_array_equal(rc.live.extract(utts), before)
    np.testing.assert_array_equal(store.solve("live-session"),
                                  iv_sess_before)
    assert store.draining() == 0


def _drain(P, toy, d):
    ex, _, p_new = _bundle_pair(P, toy, d)
    store = P.SessionStore(ex, _scfg(P))
    store.update("old1", _chunk(0))
    store.update("old2", _chunk(1))
    rc = P.RolloutController(ex, store=store)
    rep = rc.roll(p_new, shadow_utts=[_chunk(9, 40)], policy="drain")
    store.update("new1", _chunk(2))
    draining = [store.draining()]
    assert store.session("new1").binding is not store.session("old1").binding
    store.close("old1")
    store.close("old2")
    draining.append(store.draining())
    return rep.outcome, rep.sessions, draining, store.stats


def test_rollout_drain_policy_pins_old_sessions_matches_jax(toy, tmp_path):
    got = _drain(T, toy, tmp_path / "t")
    assert got[:3] == ("swapped", {"migrated": 0, "pinned_to_old": 2},
                       [2, 0])
    assert got[3]["drained_bundles"] == 1
    assert got == _drain(J, toy, tmp_path / "j")


def test_rollout_rejects_corrupt_bundle(toy, tmp_path):
    ex, p_same, _ = _bundle_pair(T, toy, tmp_path)
    npz = next(p_same.glob("step_*")) / "arrays.npz"
    raw = bytearray(npz.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    npz.write_bytes(bytes(raw))
    rc = T.RolloutController(ex)
    rep = rc.roll(p_same, shadow_utts=[_chunk(0, 40)])
    assert rep.outcome == "rejected"
    assert "shadow-load failed" in rep.reason
    assert rc.live is ex and rc.prev is None


def test_rollout_auto_rollback_on_post_swap_failure(toy, tmp_path):
    ex, p_same, _ = _bundle_pair(T, toy, tmp_path)
    rc = T.RolloutController(ex)
    cand = T.IVectorExtractor.from_bundle(p_same, serving=ex.serving,
                                          device="cpu")
    calls = {"n": 0}
    orig = cand.health_check

    def flaky_probe():
        calls["n"] += 1
        h = orig()
        if calls["n"] >= 2:                # canary passes, post-swap fails
            h = dict(h, ok=False, error="induced post-swap fault")
        return h

    cand.health_check = flaky_probe
    rc.shadow_load = lambda path: cand
    rep = rc.roll("ignored", shadow_utts=[_chunk(0, 40)])
    assert rep.outcome == "rolled_back"
    assert "post-swap probe failed" in rep.reason
    assert rc.live is ex and rc.prev is None


# ---------------------------------------------------------------------------
# Admission: preemption, adaptive batching, ordering, health
# ---------------------------------------------------------------------------


def _flags(res):
    return {k: (r.expired, r.preempted, r.kind, r.sid, r.ivector is None)
            for k, r in res.items()}


def _preempt(P, toy):
    clock = Clock()
    q = P.AdmissionQueue(_ex(P, toy), max_pending=2, clock=clock)
    ids = [q.submit(_chunk(0, 40), kind="refine", timeout=5.0),
           q.submit(_chunk(1, 40), kind="refine", timeout=50.0)]
    with pytest.raises(P.QueueFull):
        q.submit(_chunk(2, 40), kind="refine")
    ids.append(q.submit(_chunk(2, 40), kind="first"))
    res = q.drain()
    return ids, _flags(res), dict(q.stats), res


def test_admission_refine_preempted_for_first_response_matches_jax(toy):
    ids, flags, stats, res = _preempt(T, toy)
    assert stats["shed_refine"] == 1 and stats["shed_full"] == 1
    assert res[ids[1]].preempted and res[ids[1]].ivector is None
    jids, jflags, jstats, jres = _preempt(J, toy)
    assert (ids, flags, stats) == (jids, jflags, jstats)
    for i in (ids[0], ids[2]):
        np.testing.assert_allclose(res[i].ivector, jres[i].ivector,
                                   rtol=TOL, atol=TOL)


def _budgets(P, toy):
    ex = _ex(P, toy, serving=dict(min_bucket=16, max_bucket=128,
                                  max_batch=8))
    q = P.AdmissionQueue(ex, max_pending=64, min_batch=1)
    out = [q.batch_budget()]
    for i in range(3):
        q.submit(_chunk(i, 40))
    out.append(q.batch_budget())
    for i in range(20):
        q.submit(_chunk(10 + i, 40))
    out.append(q.batch_budget())
    return out


def test_admission_adaptive_batch_budget_matches_jax(toy):
    assert _budgets(T, toy) == [1, 4, 8] == _budgets(J, toy)


def _ordering(P, toy):
    clock = Clock()
    q = P.AdmissionQueue(_ex(P, toy), max_pending=8, clock=clock)
    refs = [q.submit(_chunk(i, 40), kind="refine", timeout=30.0)
            for i in range(2)]
    firsts = [q.submit(_chunk(3 + i, 40), kind="first", timeout=30.0)
              for i in range(2)]
    res = q.drain(budget=2)
    left = len(q)
    clock.t = 31.0                         # the refinements' deadline passes
    res2 = q.drain(budget=2)
    return (refs, firsts, sorted(res), left, _flags(res), _flags(res2),
            dict(q.stats))


def test_admission_budgeted_drain_serves_first_before_refine(toy):
    got = _ordering(T, toy)
    refs, firsts, served, left, _, flags2, stats = got
    assert served == sorted(firsts) and left == 2
    assert all(flags2[r][0] for r in refs) and stats["shed_deadline"] == 2
    assert got == _ordering(J, toy)


def _routing(P, toy):
    ex = _ex(P, toy)
    store = P.SessionStore(ex, _scfg(P))
    q = P.AdmissionQueue(ex, max_pending=8, store=store, clock=Clock())
    rid1 = q.submit(_chunk(0), kind="first", sid="sA")
    rid2 = q.submit(_chunk(1, 40))          # stateless batch request
    res = q.drain(q.batch_budget())
    assert res[rid1].info.first_chunk and res[rid2].sid is None
    assert store.session("sA").chunks == 1
    h = q.health()
    assert h["ok"] and h["mode"] == ex.mode and h["extractor"]["ok"]
    h["extractor"].pop("latency_s")
    return _flags(res), h, res


def test_admission_routes_sessions_and_reports_health_matches_jax(toy):
    flags, h, res = _routing(T, toy)
    assert h["sessions"]["sessions_open"] == 1
    for key in ("depth", "max_pending", "batch_budget", "shed_full",
                "shed_deadline", "shed_refine", "served", "submitted"):
        assert key in h["queue"]
    jflags, jh, jres = _routing(J, toy)
    assert flags == jflags
    assert h["queue"] == jh["queue"] and h["sessions"] == jh["sessions"]
    assert set(h["extractor"]) == set(jh["extractor"])
    for k in res:
        np.testing.assert_allclose(res[k].ivector, jres[k].ivector,
                                   rtol=TOL, atol=TOL)


def test_serving_exports_match_jax():
    assert TS.__all__ == JS.__all__


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_serve_ivector_streaming_smoke(tmp_path, capsys):
    serve_ivector.main(["--device", "cpu", "--smoke", "--streaming",
                        "--requests", "12", "--save-bundle",
                        str(tmp_path / "bundle"), "--journal-dir",
                        str(tmp_path / "journal")])
    out = capsys.readouterr().out
    assert "readiness: ok=True" in out
    assert "streamed 12 sessions" in out
    assert "'sessions_closed': 12" in out
