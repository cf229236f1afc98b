"""The port's selective scan at every d_state from 1 to 256 against the
JAX package, on the CPU.

The kernels take any d_state from 1 to 256 at each ``scan_dtype``,
forward and backward (``kernels/selective_scan.py``): up to 64 the
instance of its width, past 64 the 64-state instance once for each group
of 64 states (a grid axis), the groups' partial sums over the states
added in group order. On the CPU the port runs the plain versions; the
kernels' arithmetic (``scan_lanes``, ``scan_tree_lanes``) and the
backward's algorithm (``backward_chunks``), in the groups' order, are held
here against the reference's ``_ssm_scan``, the Pallas kernel in
interpret mode and ``jax.grad``, and Jamba SMOKE at d_state 128 and 256
(one period cut to two layers) against JAX at model level. Inputs are made with numpy from a seed.
Limits, those of ``tests/test_torch_scan_dtype.py`` (which states their
reasons) and ``tests/test_torch_lm.py``:

- TOL, f32 against f32: 1e-5 x max|want|; the f32 backward against
  ``jax.grad`` of the reference's chunked associative scan (its sums in
  another order over 64-step chunks): SCAN_BWD_TOL, 1e-4.
- SCAN_TOL, EMU_TOL, GRAD_TOL, ADJ_TOL for the 16-bit forms.
- MODEL_TOL, 2e-4, and GRAD_TOL_F32, 1e-4 x each leaf's max|value|, for
  Jamba SMOKE in f32.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import selective_scan as jss  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import mamba as JMB  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import selective_scan as tss  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from test_torch_scan_dtype import (ADJ_TOL, EMU_TOL, GRAD_TOL,  # noqa: E402
                                   KEY, SCAN_TOL, _cfgs, _rel,
                                   _scan_inputs, _straight_through, _t)

TOL = 1e-5
SCAN_BWD_TOL = 1e-4
MODEL_TOL = 2e-4
GRAD_TOL_F32 = 1e-4
D_STATES = (65, 100, 128, 129, 256)
SMEM = 232448


def _ssm(ins, sd):
    y, h = JMB._ssm_scan(*(jnp.asarray(a) for a in ins),
                         scan_dtype=jnp.dtype(sd))
    return np.asarray(y), np.asarray(h)


# ---------------------------------------------------------------------------
# The kernels' functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ds", D_STATES)
def test_f32_lanes_match_pallas_and_jax(ds):
    """``scan_lanes`` (each group of 64 states on the 64-state instance's
    lanes, the groups' partial y added in order) against the plain f32
    scan (TOL), the Pallas kernel in interpret mode from a zero state
    (TOL) and the reference's ``_ssm_scan`` with h0: y and h_last (TOL)."""
    ins = _scan_inputs(ds, 2, 64, 8, ds)
    y, h = tss.scan_lanes(*(_t(a) for a in ins))
    wy, wh = tref.selective_scan(*(_t(a) for a in ins))
    assert _rel(y, wy.numpy()) <= TOL and _rel(h, wh.numpy()) <= TOL
    y0, _ = tss.scan_lanes(*(_t(a) for a in ins[:5]))
    assert _rel(y0, jss.selective_scan(*(jnp.asarray(a) for a in ins[:5]),
                                       block_t=64, block_d=8,
                                       interpret=True)) <= TOL
    jy, jh = _ssm(ins, "float32")
    assert _rel(y, jy) <= TOL and _rel(h, jh) <= TOL


@pytest.mark.parametrize("sd", ["bfloat16", "float16"])
@pytest.mark.parametrize("ds", D_STATES)
def test_tree_lanes_match_plain_and_jax(ds, sd):
    """``scan_tree_lanes`` (the tree kernel's counter of blocks, each group
    of 64 states on 16 lanes of 4, a ragged T of one chunk) against the
    plain tree: h_last bitwise, y within EMU_TOL; and both against the
    reference at the scan_dtype within SCAN_TOL."""
    ins = _scan_inputs(ds + 1, 2, 70, 4, ds)
    y, h = tss.scan_tree_lanes(*(_t(a) for a in ins), scan_dtype=sd)
    wy, wh = tref.selective_scan(*(_t(a) for a in ins), scan_dtype=sd)
    assert torch.equal(h, wh)
    assert _rel(y, wy.numpy()) <= EMU_TOL
    jy, jh = _ssm(ins, sd)
    assert _rel(y, jy) <= SCAN_TOL and _rel(h, jh) <= SCAN_TOL


@pytest.mark.parametrize("sd", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("ds", D_STATES)
def test_backward_chunks_match_jax_grad(ds, sd):
    """``backward_chunks`` (several segments, T ragged, h0 and dh_last; the
    sums over the states, d(dx) and d(dt), per group and then over the
    groups in order) against ``jax.grad`` of the reference's
    ``_ssm_scan`` and autograd of the plain version: in f32 within
    SCAN_BWD_TOL and TOL; at 16 bits within GRAD_TOL, the adjoint's own
    gradients (d(dx), dB, dh0) against the straight-through f32
    recurrence within ADJ_TOL."""
    T = 40
    ins = _scan_inputs(ds + 2, 2, T, 4, ds)
    rng = np.random.default_rng(ds)
    dy = rng.standard_normal((2, T, 4)).astype(np.float32)
    dh = rng.standard_normal((2, 4, ds)).astype(np.float32)
    got = tss.backward_chunks(*(_t(a) for a in ins[:5]), _t(dy),
                              _t(ins[5]), _t(dh), seg_chunks=1,
                              scan_dtype=sd)
    assert tss.n_segments(T, 1) == 3
    _, vjp = jax.vjp(lambda *a: JMB._ssm_scan(*a, scan_dtype=jnp.dtype(sd)),
                     *(jnp.asarray(a) for a in ins))
    jg = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    ts = [_t(a).requires_grad_() for a in ins]
    yy, hh = tref.selective_scan(*ts, scan_dtype=sd)
    tg = torch.autograd.grad([yy, hh], ts, [_t(dy), _t(dh)])
    f32 = sd == "float32"
    for a, j, p in zip(got, jg, tg):
        assert _rel(a, j) <= (SCAN_BWD_TOL if f32 else GRAD_TOL[sd])
        assert _rel(a, p.numpy()) <= (TOL if f32 else GRAD_TOL[sd])
    if not f32:
        st = _straight_through(ins, sd, dy, dh)
        for i in (1, 3, 5):
            assert _rel(got[i], st[i].numpy()) <= ADJ_TOL, i


# ---------------------------------------------------------------------------
# The launch geometry and the domain
# ---------------------------------------------------------------------------


def test_geometry_fits_and_groups_as_the_cuda_side():
    """At every d_state from 1 to 256: the instance is the one
    ``instance`` of csrc/selective_scan.cuh names (read from the source),
    the groups cut the states in 64s, the backward's scratch rows are the
    groups' instances wide, and every block's shared memory, forward in
    both forms and backward, fits the card's 232,448 bytes."""
    src = (_build.CSRC / "selective_scan.cuh").read_text()
    expr = re.search(r"constexpr int instance\(int ds\) \{\s+return ([^;]+);",
                     src).group(1)
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    expr = " ".join(expr.split())
    for name, val in consts.items():
        expr = re.sub(rf"\b{name}\b", val, expr)
    arms = re.findall(r"([^?:]+)\?\s*(\d+)\s*:", expr)
    assert int(consts["GROUP"]) == tss.GROUP
    assert int(consts["MAX_DS"]) == tss.D_STATES[-1]

    def instance(ds):
        for cond, val in arms:
            if eval(cond, {}, {"ds": ds}):
                return int(val)
        return int(expr.rsplit(":", 1)[1])
    for ds in tss.D_STATES:
        assert tss.instance(ds) == instance(ds)
        ng = tss.groups(ds)
        assert ng == -(-ds // 64) and (ng == 1) == (ds <= 64)
        assert tss.width(ds) == tss.instance(ds) * ng >= ds
        assert tss.geometry(ds)[:2] == tss.bwd_geometry(ds)[:2] == (
            tss.instance(ds), ng)
        for sd in ("float32", "bfloat16"):
            assert 0 < tss.smem_bytes(ds, sd) <= SMEM
        assert 0 < tss.bwd_smem_bytes(ds) <= SMEM
    assert instance(257) == 0


def test_past_256_raises_naming_the_domain():
    """d_state 257 raises in both wrappers and in the geometry, naming the
    domain, before any device is touched; 256 is refused only for lying
    on the CPU."""
    for ds, match in ((257, "d_state 1 to 256, not 257"), (256, "CUDA")):
        dt = torch.zeros(1, 4, 8)
        A, Bc = torch.zeros(8, ds), torch.zeros(1, 4, ds)
        with pytest.raises(ValueError, match=match):
            tss.selective_scan(dt, dt, A, Bc, Bc)
        with pytest.raises(ValueError, match=match):
            tss.selective_scan_bwd(dt, dt, A, Bc, Bc,
                                   torch.zeros(1, 1, 8, ds), dt)
    for fn in (tss.instance, tss.groups, tss.geometry, tss.bwd_geometry):
        with pytest.raises(ValueError, match="d_state 1 to 256"):
            fn(257)
    assert tss.selective_scan.launches == 0
    assert tss.selective_scan_bwd.launches == 0


# ---------------------------------------------------------------------------
# Jamba at d_state 128 and 256
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ds", [128, 256])
def test_jamba_prefill_and_grads_match_jax(ds):
    """Jamba SMOKE without experts, f32, ``ssm.d_state`` overridden and
    cut to one period of two layers (attention, then Mamba: the SMOKE
    period's eight layers compile four times as long in JAX, for the same
    two layer bodies), JAX-drawn params carried across: the prefill's
    logits (70 tokens) within MODEL_TOL, ``loss_fn`` within MODEL_TOL and
    the gradient of every param leaf within GRAD_TOL_F32 x its max|value|
    of ``jax.value_and_grad``'s."""
    cut = {"n_layers": 2, "attn_period": 2}
    jc, tc = _cfgs("float32", **cut)
    jc = jc.with_overrides(ssm=dataclasses.replace(jc.ssm, d_state=ds))
    tc = tc.with_overrides(ssm=dataclasses.replace(tc.ssm, d_state=ds))
    jp = japi.init_params(jc, jax.random.fold_in(KEY, ds))
    tp = convert.lm_params_from_numpy({k: np.asarray(v) for k, v in
                                       jp.items()}, "float32", device="cpu")
    assert tp[next(k for k in tp if k.endswith("A_log"))].shape[-1] == ds
    rng = np.random.default_rng(ds)
    tokens = rng.integers(0, jc.vocab_size, (2, 70)).astype(np.int32)
    _, jlog = jax.jit(japi.make_prefill_step(jc))(
        jp, {"tokens": jnp.asarray(tokens)})
    _, tlog = tapi.make_prefill_step(tc)(tp, {"tokens": _t(tokens)})
    assert _rel(tlog, jlog) <= MODEL_TOL
    b = {"tokens": tokens[:, :32], "labels": np.roll(tokens[:, :32], -1, 1)}
    jl, jg = jax.jit(jax.value_and_grad(lambda p: japi.loss_fn(
        jc, p, {k: jnp.asarray(v) for k, v in b.items()})))(jp)
    names = sorted(tp)
    leaves = [tp[k].requires_grad_() for k in names]
    tl = tapi.loss_fn(tc, dict(zip(names, leaves)),
                      {k: _t(v) for k, v in b.items()})
    tg = torch.autograd.grad(tl, leaves)
    assert _rel(tl, jl) <= MODEL_TOL
    for k, g in zip(names, tg):
        assert _rel(g, jg[k]) <= GRAD_TOL_F32, k
