"""Parity of the port's Mixture-of-Experts FFN (``repro_torch.models.moe``)
and the archs with experts (Moonlight 16B-A3B, Arctic 480B, Jamba v0.1
with its experts) with the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages; params
are drawn by the JAX ``init_params`` and carried across with
``convert.lm_params_from_numpy``. Everything runs at the f32 SMOKE
configs and their published capacity factor (1.25), which drops tokens.
Tolerances, as ``tests/test_torch_lm.py`` holds the other models: 1e-5
for the MoE layer and its parts (the same f32 products summed in another
order), 2e-4 for a model's prefill, decode and loss (a few layers of
such differences); gradients of ``loss_fn`` within 1e-4 of each leaf's
largest |value| (the f32 sums of a backward pass through two layers).
The routing decisions (expert choices, slots, drops) are equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig as JShape  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import ShapeConfig as TShape  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

KEY = jax.random.PRNGKey(27)
TOL = 1e-5
MODEL_TOL = 2e-4
GRAD_TOL = 1e-4
MOONLIGHT, ARCTIC, JAMBA = "moonshot-v1-16b-a3b", "arctic-480b", \
    "jamba-v0.1-52b"
RWKV = "rwkv6-7b"
MOE_ARCHS = (MOONLIGHT, ARCTIC, JAMBA)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _close_rel(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), err


def _cfgs(arch, **kw):
    return (j_get_config(arch, smoke=True).with_overrides(**kw),
            t_get_config(arch, smoke=True).with_overrides(**kw))


def _model(arch, seed, **kw):
    """JAX-drawn f32 SMOKE params of ``arch`` and their port."""
    jc, tc = _cfgs(arch, **kw)
    jp = japi.init_params(jc, jax.random.fold_in(KEY, seed))
    tp = convert.lm_params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "float32", device="cpu")
    return jc, tc, jp, tp


def _moe_params(jc, seed):
    """One MoE layer's params (the JAX draw, layer axis stripped) in both
    packages."""
    table = JMOE.moe_table(jc, "moe", 1)
    jp = JL.table_init(table, jax.random.fold_in(KEY, seed), jnp.float32)
    jp = {k[len("moe/"):]: v[0] for k, v in jp.items()}
    return jp, {k: _t(v) for k, v in jp.items()}


def _tokens(jc, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# Configs and counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [MOONLIGHT, ARCTIC])
def test_configs_are_the_reference_s(arch):
    for smoke in (False, True):
        jc, tc = j_get_config(arch, smoke), t_get_config(arch, smoke)
        assert jc.__dict__.keys() == tc.__dict__.keys()
        for k, v in jc.__dict__.items():
            w = getattr(tc, k)
            if hasattr(v, "__dict__"):
                assert vars(v) == vars(w), k
            else:
                assert v == w, k


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "ivector-tvm"])
def test_n_params_and_n_active_params_match_jax(arch):
    """All ten LM archs at their published widths, nothing allocated."""
    jc, tc = j_get_config(arch), t_get_config(arch)
    assert tapi.n_params(tc, 1040) == japi.n_params(jc, 1040)
    assert tapi.n_active_params(tc, 1040) == japi.n_active_params(jc, 1040)
    if jc.moe is not None:
        assert tapi.n_active_params(tc) < tapi.n_params(tc)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_full_config_tables_match_jax(arch):
    """The param table (names and shapes) and decode cache of the
    published config with its experts, nothing allocated."""
    jc, tc = j_get_config(arch), t_get_config(arch)
    jt, tt = japi.param_table(jc), tapi.param_table(tc)
    assert {k: v[0] for k, v in jt.items()} == {k: v[0]
                                                for k, v in tt.items()}
    assert any("/moe/w_up" in k for k in tt)
    want = {k: (tuple(s.shape), str(s.dtype)) for k, s in
            japi.cache_specs(jc, JShape("t", 1040, 4, "decode"))[0].items()}
    got = {k: (tuple(s), str(d).replace("torch.", "")) for k, (s, d) in
           tapi.cache_specs(tc, TShape("t", 1040, 4, "decode")).items()}
    assert got == want


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [MOONLIGHT, JAMBA])
def test_route_matches_jax(arch):
    """Weights, choices and the GShard aux loss of ``_route``."""
    jc, tc = _cfgs(arch)
    jp, tp = _moe_params(jc, 1)
    x = np.random.default_rng(1).standard_normal((40, jc.d_model))
    x = x.astype(np.float32)
    jw, jidx, jaux = JMOE._route(jc, jp, jnp.asarray(x))
    tw, tidx, taux = TMOE._route(tc, tp, _t(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tw, jw)
    _close(taux, jaux)


def test_route_breaks_ties_to_the_lowest_index():
    """Equal router probabilities (a zero router, and a router whose
    columns come in equal pairs): the choices are ``lax.top_k``'s, the
    lowest expert index first."""
    jc, tc = _cfgs(MOONLIGHT)
    jp, tp = _moe_params(jc, 2)
    x = np.random.default_rng(2).standard_normal((9, jc.d_model))
    x = x.astype(np.float32)
    pair = np.asarray(jp["router"])[:, ::2].repeat(2, axis=1)
    for router in (np.zeros_like(pair), pair):
        jp2, tp2 = dict(jp, router=jnp.asarray(router)), dict(
            tp, router=_t(router))
        _, jidx, _ = JMOE._route(jc, jp2, jnp.asarray(x))
        _, tidx, _ = TMOE._route(tc, tp2, _t(x))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert (tidx.numpy()[:, 0] % 2 == 0).all()


def test_positions_in_expert_match_jax():
    rng = np.random.default_rng(3)
    for E, K in ((8, 2), (64, 6), (4, 1)):
        idx = np.stack([rng.permutation(E)[:K] for _ in range(37)])
        want = JMOE._positions_in_expert(jnp.asarray(idx), E)
        got = TMOE._positions_in_expert(_t(idx).long(), E)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch,cf,drops", [
    (MOONLIGHT, 1.25, True),      # the published factor drops here
    (MOONLIGHT, 64.0, False),
    (ARCTIC, 0.5, True),
    (JAMBA, 1.0, True),
])
def test_moe_dense_matches_jax(arch, cf, drops):
    """``moe_dense`` over [B, S, d] (the dropped choices add zero) and its
    aux loss against JAX's; ``drops`` says whether some choice of this
    input passes its expert's capacity."""
    jc, tc = _cfgs(arch)
    m = jc.moe.__class__(**{**vars(jc.moe), "capacity_factor": cf})
    jc, tc = jc.with_overrides(moe=m), tc.with_overrides(moe=m)
    jp, tp = _moe_params(jc, 4)
    x = np.random.default_rng(4).standard_normal((2, 24, jc.d_model))
    x = x.astype(np.float32)
    jy, jaux = JMOE.moe_dense(jc, jp, jnp.asarray(x))
    ty, taux = TMOE.moe_dense(tc, tp, _t(x))
    assert ty.shape == x.shape
    _close(ty, jy)
    _close(taux, jaux)
    T = 48
    cap = max(1, int(T * m.top_k * cf / m.n_experts))
    _, idx, _ = TMOE._route(tc, tp, _t(x).reshape(T, -1))
    pos = TMOE._positions_in_expert(idx, m.n_experts)
    assert bool((pos >= cap).any()) == drops


def test_moe_dense_grads_match_jax():
    """The gradient of sum(y c) + aux over x and every MoE param against
    ``jax.grad``, at the published factor (tokens dropped)."""
    jc, tc = _cfgs(MOONLIGHT)
    jp, tp = _moe_params(jc, 5)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, jc.d_model)).astype(np.float32)
    c = rng.standard_normal(x.shape).astype(np.float32)

    def jf(xx, pp):
        y, aux = JMOE.moe_dense(jc, pp, xx)
        return jnp.sum(y * c) + aux
    jgx, jgp = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jp)
    tx = _t(x).requires_grad_()
    names = sorted(tp)
    leaves = [tp[k].clone().requires_grad_() for k in names]
    y, aux = TMOE.moe_dense(tc, dict(zip(names, leaves)), tx)
    grads = torch.autograd.grad((y * _t(c)).sum() + aux, [tx] + leaves)
    _close_rel(grads[0], jgx, GRAD_TOL)
    for k, g in zip(names, grads[1:]):
        _close_rel(g, jgp[k], GRAD_TOL)


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
def test_moe_ffn_matches_jax(kind):
    """The selector with no sharding rules active picks ``moe_dense`` in
    both packages, for every kind of call (1e-5)."""
    jc, tc = _cfgs(MOONLIGHT)
    jp, tp = _moe_params(jc, 6)
    x = np.random.default_rng(6).standard_normal(
        (2, 8, jc.d_model)).astype(np.float32)
    jy, jaux = JMOE.moe_ffn(jc, jp, jnp.asarray(x), kind)
    ty, taux = TMOE.moe_ffn(tc, tp, _t(x), kind)
    _close(ty, jy)
    _close(taux, jaux)


# ---------------------------------------------------------------------------
# Whole models against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill logits (and cache) at the published capacity factor, then
    decode steps (T = batch: the decode capacity drops choices the
    prefill keeps, in both packages) against JAX's; Jamba from a zero
    cache, the others from the prefill's cache padded to the window."""
    jc, tc, jp, tp = _model(arch, 10)
    assert any("/moe/" in k for k in tp)
    B, S, G = 2, 12, 3
    tokens = _tokens(jc, B, S + G, 10)
    jcache, jlog = jax.jit(japi.make_prefill_step(jc))(
        jp, {"tokens": jnp.asarray(tokens[:, :S])})
    tcache, tlog = tapi.make_prefill_step(tc)(tp, {"tokens": _t(
        tokens[:, :S])})
    _close(tlog, jlog, MODEL_TOL)
    if jc.family == "hybrid":
        assert jcache is None and tcache is None
        jcache = {k: jnp.zeros(s.shape, s.dtype) for k, s in japi.cache_specs(
            jc, JShape("t", S + G, B, "decode"))[0].items()}
        tcache = tapi.zero_cache(tc, TShape("t", S + G, B, "decode"), "cpu")
        first = 0
    else:
        for k in ("k", "v"):
            _close(tcache[k], jcache[k], MODEL_TOL)
        jcache = jserve.pad_cache(jcache, S + G)
        tcache = tserve.pad_cache(tcache, S + G)
        first = S
    jdec = jax.jit(japi.make_decode_step(jc))
    tdec = tapi.make_decode_step(tc)
    for t in range(first, S + G):
        jcache, jlog = jdec(jp, jcache, {"token": jnp.asarray(tokens[:, t]),
                                         "pos": jnp.asarray(t, jnp.int32)})
        tcache, tlog = tdec(tp, tcache, {"token": _t(tokens[:, t]),
                                         "pos": t})
        _close(tlog, jlog, MODEL_TOL)


def test_decode_matches_prefill_at_a_large_capacity():
    """With ``capacity_factor`` 64 nothing is dropped, so the prefill of
    S - 1 tokens plus one decode step gives the prefill of S's last
    logits, as the reference's test_decode_matches_full_forward holds."""
    _, tc, _, tp = _model(MOONLIGHT, 11)
    m = tc.moe.__class__(**{**vars(tc.moe), "capacity_factor": 64.0})
    tc = tc.with_overrides(moe=m)
    tokens = _t(_tokens(tc, 2, 16, 11))
    pre, dec = tapi.make_prefill_step(tc), tapi.make_decode_step(tc)
    _, want = pre(tp, {"tokens": tokens})
    cache, _ = pre(tp, {"tokens": tokens[:, :-1]})
    _, got = dec(tp, tserve.pad_cache(cache, 16),
                 {"token": tokens[:, -1], "pos": 15})
    _close(got, want, 2e-3)


@pytest.fixture(scope="module")
def jax_states():
    """arch -> (JAX f32 SMOKE params as numpy, a batch)."""
    out = {}
    for i, arch in enumerate(MOE_ARCHS):
        jc, _ = _cfgs(arch)
        jp = japi.init_params(jc, jax.random.fold_in(KEY, 20 + i))
        tokens = _tokens(jc, 2, 17, 20 + i)
        out[arch] = ({k: np.asarray(v) for k, v in jp.items()},
                     {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})
    return out


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_grads_match_jax(jax_states, arch):
    """``loss_fn`` (the chunked loss plus router_aux_loss x the summed aux
    loss) and the gradient of every param leaf against
    ``jax.value_and_grad`` of the JAX ``loss_fn``."""
    jc, tc = _cfgs(arch)
    params, batch = jax_states[arch]
    jl, jg = jax.value_and_grad(lambda p, b: japi.loss_fn(jc, p, b))(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in batch.items()})
    tp = convert.lm_params_from_numpy(params, "float32", "cpu")
    names = sorted(tp)
    leaves = [tp[k].requires_grad_() for k in names]
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tl = tapi.loss_fn(tc, dict(zip(names, leaves)), tb)
    _close(tl, jl, MODEL_TOL)
    tg = torch.autograd.grad(tl, leaves)
    assert set(names) == set(jg)
    for k, g in zip(names, tg):
        _close_rel(g, jg[k], GRAD_TOL)
    # the aux term is there: without it the loss is the cross-entropy's
    nomoe = tapi.loss_fn(tc.with_overrides(moe=tc.moe.__class__(
        **{**vars(tc.moe), "router_aux_loss": 0.0})), dict(zip(names, leaves)),
        tb)
    assert float((tl - nomoe).detach()) > 0


@pytest.mark.parametrize("arch", [MOONLIGHT, JAMBA])
def test_train_step_repeats_bitwise_and_remat_changes_nothing(arch):
    """One train step on the CPU: the same bits from the same state, with
    each layer recomputed in the backward pass or not."""
    _, tc, _, tp = _model(arch, 30)
    tokens = _t(_tokens(tc, 2, 17, 30))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    outs = []
    for remat in ("nothing", "layer", "layer"):
        cfg = tc.with_overrides(remat=remat)
        state = {"params": {k: v.clone() for k, v in tp.items()},
                 "opt": tapi.adamw_init(tp, tapi._opt_config(cfg, None))}
        outs.append(tapi.make_train_step(cfg)(state, batch))
    assert torch.isfinite(outs[0][1]["loss"])
    for k in tp:
        assert torch.equal(outs[0][0]["params"][k], outs[1][0]["params"][k])
        assert torch.equal(outs[1][0]["params"][k], outs[2][0]["params"][k])


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [MOONLIGHT, RWKV])
def test_train_main_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.train --arch ... --smoke --device
    cpu``: the moe and ssm families train, as in the JAX launcher."""
    out = tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--steps", "2", "--batch", "2", "--seq", "32",
                        "--log-every", "1"])
    assert out["final_step"] == 2 and len(out["losses"]) == 2
    assert np.isfinite(out["losses"]).all()
    assert "first loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch,layers,fits", [
    (ARCTIC, 0, False), (JAMBA, 0, False), (MOONLIGHT, 0, False),
    (MOONLIGHT, 4, True), (RWKV, 8, True)])
def test_train_launcher_checks_the_state_fits_a_card(arch, layers, fits):
    """``check_fits`` at an H100's 80 GB: at full width Arctic's, Jamba
    with experts' and Moonlight's params, gradients and moments are past
    it and the launcher exits naming how many such cards the sharded
    state needs; Moonlight at 4 layers and RWKV-6 at 8 (phase 13's
    training rows) fit."""
    cfg = t_get_config(arch)
    if layers:
        cfg = cfg.with_overrides(n_layers=layers)
    if fits:
        tlaunch.check_fits(cfg, 4096, 80 * 10**9)
    else:
        need = tlaunch.state_bytes(cfg, 4096)
        with pytest.raises(SystemExit, match=f"at least "
                           f"{-(-need // (80 * 10**9))} cards"):
            tlaunch.check_fits(cfg, 4096, 80 * 10**9)


def test_serve_moe_on_cpu(capsys, monkeypatch):
    """``serve`` at SMOKE size for the moe family: the same tokens from
    the same seed, the first the prefill's argmax; then ``main``."""
    tc = t_get_config(MOONLIGHT, smoke=True)
    runs = [tserve.serve(tc, 2, 16, 4, torch.Generator().manual_seed(3),
                         "cpu") for _ in range(2)]
    r = runs[0]
    assert r["tokens"].shape == (2, 4)
    assert torch.isfinite(r["last_logits"]).all()
    assert torch.equal(r["tokens"], runs[1]["tokens"])
    assert torch.equal(r["tokens"][:, 0],
                       torch.argmax(r["prefill_logits"], -1))
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", MOONLIGHT, "--smoke", "--batch", "2",
        "--prompt-len", "16", "--gen", "3", "--device", "cpu"])
    tserve.main()
    out = capsys.readouterr().out
    assert "prefill: 2x16" in out and "decode: 2 steps" in out


# ---------------------------------------------------------------------------
# table_init's sliced draw
# ---------------------------------------------------------------------------


def test_table_init_draws_in_slices(monkeypatch):
    """Under a small ``DRAW_SLICE`` every kind of init keeps its shape,
    dtype and values' law: a large normal table's sample mean and standard
    deviation (within 5 standard errors), a uniform's range and mean, the
    constants exact. A table under the slice is one draw, the same numbers
    as before slicing."""
    monkeypatch.setattr(TL, "DRAW_SLICE", 1000)
    table = {"a": ((3, 40, 50), (), ("normal", 0.5)),
             "b": ((7, 300), (), ("uniform", -2.0, 1.0)),
             "c": ((2, 900), (), ("const", 0.25)),
             "d": ((5, 3, 400), (), ("ones",)),
             "e": ((20, 20), (), ("zeros",))}
    for dtype in (torch.float32, torch.bfloat16):
        out = TL.table_init(table, torch.Generator().manual_seed(0), dtype,
                            "cpu")
        for k, (shape, _, _) in table.items():
            assert out[k].shape == shape and out[k].dtype == dtype
        a = out["a"].double()
        se = 0.5 / np.sqrt(a.numel())
        assert abs(a.mean().item()) < 5 * se
        assert abs(a.std().item() - 0.5) < 5 * 0.5 / np.sqrt(2 * a.numel())
        # every slice drew its own numbers
        assert not torch.equal(out["a"][0], out["a"][1])
        b = out["b"].double()
        assert b.min() >= -2.0 and b.max() <= 1.0
        assert abs(b.mean().item() + 0.5) < 5 * 3 / np.sqrt(12 * b.numel())
        assert (out["c"] == 0.25).all() and (out["d"] == 1).all()
        assert (out["e"] == 0).all()
    small = {"w": ((4, 30), (), ("normal", 0.02))}
    got = TL.table_init(small, torch.Generator().manual_seed(1),
                        torch.float32, "cpu")["w"]
    want = torch.randn((4, 30), generator=torch.Generator().manual_seed(1))
    assert torch.equal(got, want.mul_(0.02))


def test_adamw_update_in_slices_is_bitwise(monkeypatch):
    """``adamw_update`` cuts a large leaf along its leading axis
    (``UPDATE_SLICE``) so that its f32 temporaries stay one slice's size:
    the update is elementwise, so any cut gives the same bits, f32 and bf16
    params and moments, a scalar leaf and a leaf whose one row is over the
    slice included."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import adamw as TA
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(5, 30, 7, generator=g),
              "b": torch.randn(3, generator=g),
              "c": torch.randn((), generator=g),
              "d": torch.randn(40, 50, generator=g).bfloat16(),
              "e": torch.randn(2, 300, generator=g)}
    grads = {k: torch.randn(v.shape, generator=g).to(v.dtype)
             for k, v in params.items()}
    outs = []
    for dt in ("float32", "bfloat16"):
        oc = AdamWConfig(moment_dtype=dt, warmup_steps=1)
        st = TA.adamw_init(params, oc)
        st["m"] = {k: torch.randn(v.shape, generator=g).to(v.dtype)
                   for k, v in st["m"].items()}
        whole = TA.adamw_update(params, grads, st, oc)
        for cut in (100, 1):
            monkeypatch.setattr(TA, "UPDATE_SLICE", cut)
            part = TA.adamw_update(params, grads, st, oc)
            monkeypatch.undo()
            for k in params:
                assert torch.equal(part[0][k], whole[0][k])
                for w in ("m", "v"):
                    assert torch.equal(part[1][w][k], whole[1][w][k])
        outs.append(whole)
    assert outs[1][1]["m"]["a"].dtype == torch.bfloat16
