"""The port's Mamba layer and Jamba SMOKE at a 16-bit ``scan_dtype``
against the JAX package, on the CPU: ``mamba_mix`` with and without a
carried state, Jamba's prefill, decode steps and a train step's loss and
gradients, and the autograd functions' glue on the tree form. The scan
itself, its emulations and the limits are in
``tests/test_torch_scan_dtype.py``, whose helpers these tests share.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig as JShape  # noqa: E402
from repro.data.tokens import TokenPipeline as JPipe  # noqa: E402
from repro.data.tokens import TokenPipelineConfig as JPipeCfg  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba as JMB  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ShapeConfig as TShape  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import selective_scan as tss  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import mamba as TMB  # noqa: E402
from test_torch_scan_dtype import (DTYPES, EMU_TOL, GRAD_TOL, KEY,  # noqa: E402
                                   MODEL_TOL, _cfgs, _rel, _t)


@pytest.mark.parametrize("sd", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_mix_matches_jax(sd, with_state):
    """One Mamba layer at the scan_dtype, with and without a carried
    state: output, conv tail and state within MODEL_TOL of JAX's."""
    jc, tc = _cfgs(sd)
    table = JMB.mamba_table(jc, "m", 1)
    jp = JL.table_init(table, jax.random.fold_in(KEY, 8), jnp.float32)
    jp = {k[2:]: v[0] for k, v in jp.items()}
    tp = convert.lm_params_from_numpy({k: np.asarray(v) for k, v in
                                       jp.items()}, "float32", device="cpu")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 70, jc.d_model)).astype(np.float32)
    di, _, ds, dc = JMB.dims(jc)
    state = ((rng.standard_normal((2, dc - 1, di)).astype(np.float32),
              rng.standard_normal((2, di, ds)).astype(np.float32))
             if with_state else None)
    want, (wtail, wh) = JMB.mamba_mix(
        jc, jp, jnp.asarray(x),
        None if state is None else tuple(jnp.asarray(a) for a in state))
    got, (gtail, gh) = TMB.mamba_mix(
        tc, tp, _t(x), None if state is None else tuple(_t(a)
                                                          for a in state))
    for g, w in ((got, want), (gtail, wtail), (gh, wh)):
        assert _rel(g, w) <= MODEL_TOL[sd]


@pytest.mark.parametrize("sd", DTYPES)
def test_jamba_prefill_and_decode_match_jax(sd):
    """Jamba SMOKE without experts at the scan_dtype: the prefill's logits
    (70 tokens: a 64-step chunk does not divide them, so one ragged chunk),
    then decode steps from a zero cache, each step's logits and the final
    cache, against JAX's within MODEL_TOL x max|value|."""
    jc, tc = _cfgs(sd)
    jp = japi.init_params(jc, jax.random.fold_in(KEY, 20))
    tp = convert.lm_params_from_numpy({k: np.asarray(v) for k, v in
                                       jp.items()}, "float32", device="cpu")
    B, S = 2, 70
    tokens = np.random.default_rng(20).integers(0, jc.vocab_size, (B, S))
    tokens = tokens.astype(np.int32)
    _, jlog = jax.jit(japi.make_prefill_step(jc))(
        jp, {"tokens": jnp.asarray(tokens)})
    _, tlog = tapi.make_prefill_step(tc)(tp, {"tokens": _t(tokens)})
    assert _rel(tlog, jlog) <= MODEL_TOL[sd]
    steps = 4
    jcache = {k: jnp.zeros(s.shape, s.dtype) for k, s in
              japi.cache_specs(jc, JShape("t", steps, B, "decode"))[0].items()}
    tcache = tapi.zero_cache(tc, TShape("t", steps, B, "decode"), "cpu")
    jdec = jax.jit(japi.make_decode_step(jc))
    tdec = tapi.make_decode_step(tc)
    for t in range(steps):
        jcache, jlog = jdec(jp, jcache, {"token": jnp.asarray(tokens[:, t]),
                                         "pos": jnp.asarray(t, jnp.int32)})
        tcache, tlog = tdec(tp, tcache, {"token": _t(tokens[:, t]),
                                         "pos": t})
        assert _rel(tlog, jlog) <= MODEL_TOL[sd]
    for k in ("conv", "h"):
        assert _rel(tcache[k], jcache[k]) <= MODEL_TOL[sd]


@pytest.mark.parametrize("sd", ["bfloat16"])
def test_jamba_train_step_matches_jax(sd):
    """Jamba SMOKE at the scan_dtype from JAX's initial state: the loss
    within MODEL_TOL and every param's gradient (``loss_fn``'s, through
    autograd of the plain tree) within GRAD_TOL x its largest |value| of
    ``jax.value_and_grad``'s; then one ``make_train_step`` step of the
    port, whose loss and grad norm are those."""
    jc, tc = _cfgs(sd)
    state = jax.tree.map(np.asarray,
                         japi.init_state(jc, jax.random.PRNGKey(30)))
    pipe = JPipe(JPipeCfg(vocab_size=jc.vocab_size, seq_len=32,
                          global_batch=2))
    batch = pipe.next()
    jl, jg = jax.value_and_grad(lambda p, b: japi.loss_fn(jc, p, b))(
        {k: jnp.asarray(v) for k, v in state["params"].items()},
        {k: jnp.asarray(v) for k, v in batch.items()})
    tp = convert.lm_params_from_numpy(state["params"], "float32", "cpu")
    names = sorted(tp)
    leaves = [tp[k].requires_grad_() for k in names]
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tl = tapi.loss_fn(tc, dict(zip(names, leaves)), tb)
    tg = torch.autograd.grad(tl, leaves)
    assert _rel(tl, jl) <= MODEL_TOL[sd]
    for k, g in zip(names, tg):
        assert _rel(g, jg[k]) <= GRAD_TOL[sd], k
    _, tm = tapi.make_train_step(tc)(
        convert.lm_state_from_numpy(state, "float32", "cpu"), tb)
    jnorm = np.sqrt(sum(float(np.square(np.asarray(g, np.float64)).sum())
                        for g in jg.values()))
    assert _rel(tm["loss"], jl) <= MODEL_TOL[sd]
    assert _rel(tm["grad_norm"], jnorm) <= GRAD_TOL[sd]


@pytest.mark.parametrize("sd", DTYPES)
def test_autograd_function_glue_tree_form(monkeypatch, sd):
    """The card's path through ``ops`` at a 16-bit scan_dtype run on the
    CPU: ``ops`` is told the tensors lie on the card and the wrappers are
    replaced by their plain counterparts (the plain tree with the states
    it saves every BT steps; ``backward_chunks``). A Mamba layer's output
    with a carried state equals the plain path's (EMU_TOL), and its
    gradients, the f32 adjoint, are within GRAD_TOL of the plain path's
    autograd, which rounds the cotangents."""
    jc, tc = _cfgs(sd)
    jp = JL.table_init(JMB.mamba_table(jc, "m", 1),
                       jax.random.fold_in(KEY, 9), jnp.float32)
    params = {k[2:]: np.asarray(v[0]) for k, v in jp.items()}
    rng = np.random.default_rng(9)
    di, _, ds, dc = JMB.dims(jc)
    x = rng.standard_normal((2, 40, jc.d_model)).astype(np.float32)
    state = (_t(rng.standard_normal((2, dc - 1, di)).astype(np.float32)),
             _t(rng.standard_normal((2, di, ds)).astype(np.float32)))
    seen = []

    def fake_ss(dt, dx, A, Bc, Cc, h0=None, save_states=False,
                scan_dtype="float32"):
        seen.append(scan_dtype)
        y, h, starts = tref.selective_scan_tree(dt, dx, A, Bc, Cc, h0,
                                                scan_dtype, every=tss.BT)
        return (y, h, torch.stack(starts, 1)) if save_states else (y, h)

    def fake_ss_bwd(dt, dx, A, Bc, Cc, hs, dy, dh_last=None,
                    want_dh0=False, scan_dtype="float32"):
        g = tss.backward_chunks(dt, dx, A, Bc, Cc, dy, hs[:, 0], dh_last,
                                scan_dtype=scan_dtype)
        return g[:5] + ((g[5],) if want_dh0 else (None,))

    runs = []
    for patched in (False, True):
        if patched:
            monkeypatch.setattr(tops, "_on_cuda", lambda t: True)
            monkeypatch.setattr(tss, "selective_scan", fake_ss)
            monkeypatch.setattr(tss, "selective_scan_bwd", fake_ss_bwd)
        tp = convert.lm_params_from_numpy(params, "float32", device="cpu")
        names = sorted(tp)
        leaves = [tp[k].requires_grad_() for k in names]
        h = state[1].clone().requires_grad_()
        y, _ = TMB.mamba_mix(tc, dict(zip(names, leaves)), _t(x),
                             (state[0], h))
        out = (y * torch.linspace(-1, 1, y.shape[-1])).sum()
        runs.append([y.detach()] + list(torch.autograd.grad(
            out, leaves + [h])))
    assert seen == [sd]
    assert _rel(runs[1][0], runs[0][0].numpy()) <= EMU_TOL
    for a, b in zip(runs[1][1:], runs[0][1:]):
        assert _rel(a, b.numpy()) <= GRAD_TOL[sd]
