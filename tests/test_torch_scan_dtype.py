"""The port's scan at a 16-bit ``scan_dtype`` against the JAX package, on
the CPU.

``SSMConfig.scan_dtype`` "bfloat16" or "float16" rounds the Mamba scan's
transitions to that type: the reference (``repro.models.mamba._ssm_scan``)
runs a chunked ``lax.associative_scan`` whose every combine rounds. The
port's plain version (``ref.selective_scan_tree``) follows it step for
step; the tree kernel's arithmetic (``selective_scan.scan_tree_lanes``)
and the backward's algorithm (``selective_scan.backward_chunks``) are
held here too; Jamba SMOKE's prefill, decode and a train step are in
``tests/test_torch_scan_dtype_models.py``. Inputs are made with numpy
from a seed. Limits:

- SCAN_TOL, the plain tree against the reference on y and h_last, 2e-3 x
  max|want|: read up to 2.1e-4 (y) and 1.0e-3 (h_last, one transition
  rounded the other way, torch's exp against XLA's) in bf16, 1.7e-4 and
  2.0e-4 in f16; a scan rounded to bf16 step by step reads 1.3e-2 and more,
  so the limit tells the two apart.
- The emulation against the plain tree: h_last bitwise (the same combines
  in the same order), y to EMU_TOL (the kernel's lane order of the f32 sum
  over states).
- GRAD_TOL, the backward's gradients against ``jax.grad`` and against
  autograd of the plain tree: the backward takes the recurrence's adjoint
  in f32 at the rounded transitions, where both of those round every
  cotangent to the 16-bit type (ROADMAP Queue 3). Read up to 1.6e-2 x
  max|grad| in bf16 and 2.7e-3 in f16 (jax.grad at f32 against jax.grad at
  bf16: 2.7e-2 and 5.9e-3).
- The adjoint alone (d(dx), dB, dh0) against autograd of the f32
  recurrence at the rounded transitions with each rounding passing its
  cotangent through: ADJ_TOL (f32 sums in another order).
- MODEL_TOL for the Jamba SMOKE paths (8 layers of the above).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import mamba as JMB  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs.base import SSMConfig  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import selective_scan as tss  # noqa: E402

JAMBA = "jamba-v0.1-52b"
KEY = jax.random.PRNGKey(0)
DTYPES = ("bfloat16", "float16")
SCAN_TOL = 2e-3
EMU_TOL = 1e-6
GRAD_TOL = {"bfloat16": 3e-2, "float16": 6e-3}
ADJ_TOL = 1e-5
MODEL_TOL = {"bfloat16": 1e-2, "float16": 2e-3}
f32 = torch.float32


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _scan_inputs(seed, B, T, di, ds):
    """dt = softplus(.) near 0.01 and dx = dt x, A < 0, as mamba_mix makes
    them, and an h0."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s)  # noqa: E731
    dt = np.log1p(np.exp(f(B, T, di) - 4.6)).astype(np.float32)
    return (dt, (dt * f(B, T, di)).astype(np.float32),
            (-np.exp(0.5 * f(di, ds))).astype(np.float32),
            f(B, T, ds).astype(np.float32), f(B, T, ds).astype(np.float32),
            f(B, di, ds).astype(np.float32))


def _jax_scan(ins, sd):
    y, h = JMB._ssm_scan(*(jnp.asarray(a) for a in ins),
                         scan_dtype=jnp.dtype(sd))
    return np.asarray(y), np.asarray(h)


# ---------------------------------------------------------------------------
# The scan: plain tree, kernel emulations, backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sd", DTYPES)
@pytest.mark.parametrize("T,ds,with_h0", [
    (128, 8, True), (128, 16, False), (128, 64, True),
    (100, 8, False), (100, 16, True), (100, 64, False),
    (1, 8, True), (1, 16, True), (1, 64, False)])
def test_plain_tree_matches_jax(sd, T, ds, with_h0):
    """``ref.selective_scan`` at a 16-bit scan_dtype (two 64-step chunks,
    one ragged chunk of 100, a decode step) against the reference's
    ``_ssm_scan``: y and h_last within SCAN_TOL x max|want|."""
    ins = list(_scan_inputs(T + ds, 2, T, 16, ds))
    if not with_h0:
        ins[5] = np.zeros_like(ins[5])
    wy, wh = _jax_scan(ins, sd)
    y, h = tops.selective_scan(*(_t(a) for a in ins[:5]),
                               _t(ins[5]) if with_h0 else None, sd)
    assert _rel(y, wy) <= SCAN_TOL and _rel(h, wh) <= SCAN_TOL


def test_sequential_bf16_scan_fails_the_limit():
    """The limit tells the tree from a scan rounded to bf16 step by step
    (each state rounded, as a sequential kernel that only rounds would
    run): that one is off by more than SCAN_TOL, the tree is within it."""
    ins = _scan_inputs(7, 2, 128, 16, 16)
    wy, wh = _jax_scan(ins, "bfloat16")
    dt, dx, A, Bc, Cc, h = (_t(a) for a in ins)
    bf = torch.bfloat16
    ys = []
    for t in range(dt.shape[1]):
        h = (torch.exp(dt[:, t, :, None] * A).to(bf) * h.to(bf)
             + (dx[:, t, :, None] * Bc[:, t, None, :]).to(bf)).float()
        ys.append((h.to(bf).float() * Cc[:, t, None, :].to(bf).float())
                  .sum(-1))
    assert _rel(torch.stack(ys, 1), wy) > SCAN_TOL
    y, _ = tref.selective_scan(*(_t(a) for a in ins), scan_dtype="bfloat16")
    assert _rel(y, wy) <= SCAN_TOL


@pytest.mark.parametrize("sd", DTYPES)
@pytest.mark.parametrize("T,ds", [(200, 1), (100, 12), (128, 48), (150, 64)])
def test_tree_emulation_matches_plain(sd, T, ds):
    """``scan_tree_lanes`` (the tree kernel's counter of blocks, its high
    counter at a ragged T, 4 states a lane, the instance's states past ds
    zero) against the plain tree: h_last bitwise, y within EMU_TOL x
    max|y|; and both against the reference within SCAN_TOL."""
    ins = _scan_inputs(3 * T + ds, 2, T, 8, ds)
    y, h = tss.scan_tree_lanes(*(_t(a) for a in ins), scan_dtype=sd)
    wy, wh = tref.selective_scan(*(_t(a) for a in ins), scan_dtype=sd)
    assert torch.equal(h, wh)
    assert _rel(y, wy.numpy()) <= EMU_TOL
    jy, jh = _jax_scan(ins, sd)
    assert _rel(y, jy) <= SCAN_TOL and _rel(h, jh) <= SCAN_TOL


@pytest.mark.parametrize("ds", [1, 12, 48, 64])
def test_f32_lanes_emulation_at_every_d_state(ds):
    """``scan_lanes`` at a d_state between the instances (its instance's
    states past ds zero) against the plain f32 scan, to EMU_TOL x
    max|value| (f32 sums in the lanes' order)."""
    ins = _scan_inputs(ds, 2, 40, 8, ds)
    y, h = tss.scan_lanes(*(_t(a) for a in ins))
    wy, wh = tref.selective_scan(*(_t(a) for a in ins))
    assert _rel(y, wy.numpy()) <= 10 * EMU_TOL
    assert _rel(h, wh.numpy()) <= 10 * EMU_TOL


def _straight_through(ins, sd, dy, dh):
    """Autograd of the f32 recurrence at the rounded transitions, each
    rounding passing its cotangent through: (d(dt), d(dx), dA, dB, dC,
    dh0)."""
    dtype = tref.scan_type(sd)
    st = lambda x: x + (x.to(dtype).to(f32) - x).detach()  # noqa: E731
    ts = [_t(a).requires_grad_() for a in ins]
    dt, dx, A, Bc, Cc, h = ts
    ys = []
    for t in range(dt.shape[1]):
        h = (st(torch.exp(dt[:, t, :, None] * A)) * h
             + st(dx[:, t, :, None] * Bc[:, t, None, :]))
        ys.append((st(h) * st(Cc[:, t, None, :])).sum(-1))
    return torch.autograd.grad([torch.stack(ys, 1), h], ts,
                               [_t(dy), _t(dh)])


@pytest.mark.parametrize("sd", DTYPES)
@pytest.mark.parametrize("T,ds,seg_chunks", [
    (100, 1, 2), (128, 12, 3), (64, 48, 1), (80, 64, 2)])
def test_backward_chunks_tree_form(sd, T, ds, seg_chunks):
    """``backward_chunks`` at a 16-bit scan_dtype, several segments (T
    ragged or not, h0 and dh_last), against: the same with one segment
    (1e-6 x max|grad|); the straight-through f32 recurrence on the
    adjoint's own gradients, d(dx), dB and dh0 (ADJ_TOL); ``jax.grad`` of
    the reference and autograd of the plain tree on all six (GRAD_TOL)."""
    ins = _scan_inputs(T * ds, 2, T, 8, ds)
    rng = np.random.default_rng(ds)
    dy = rng.standard_normal((2, T, 8)).astype(np.float32)
    dh = rng.standard_normal((2, 8, ds)).astype(np.float32)
    args = [_t(a) for a in ins[:5]] + [_t(dy), _t(ins[5]), _t(dh)]
    got = tss.backward_chunks(*args, seg_chunks=seg_chunks, scan_dtype=sd)
    one = tss.backward_chunks(*args, seg_chunks=10 ** 6, scan_dtype=sd)
    assert tss.n_segments(T, seg_chunks) > 1 or seg_chunks == 1
    for a, b in zip(got, one):
        assert _rel(a, b.numpy()) <= EMU_TOL
    st = _straight_through(ins, sd, dy, dh)
    for i in (1, 3, 5):
        assert _rel(got[i], st[i].numpy()) <= ADJ_TOL, i
    _, vjp = jax.vjp(lambda *a: JMB._ssm_scan(*a, scan_dtype=jnp.dtype(sd)),
                     *(jnp.asarray(a) for a in ins))
    jg = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    ts = [_t(a).requires_grad_() for a in ins]
    y, h = tref.selective_scan(*ts, scan_dtype=sd)
    tg = torch.autograd.grad([y, h], ts, [_t(dy), _t(dh)])
    for a, j, p in zip(got, jg, tg):
        assert _rel(a, j) <= GRAD_TOL[sd]
        assert _rel(a, p.numpy()) <= GRAD_TOL[sd]


def test_scan_dtype_names():
    """The config takes the three names ``jnp.dtype`` reads for the scan
    and refuses others; so do ``ops.selective_scan`` and the wrappers'
    forms."""
    for sd in ("float32", "bfloat16", "float16"):
        assert SSMConfig(scan_dtype=sd).scan_dtype == sd
        assert tref.scan_type(sd) == getattr(torch, sd)
        assert tss.FORMS[sd] == tss.form(sd)
    for bad in ("bf16", "float64", "int8"):
        with pytest.raises(ValueError, match="scan_dtype"):
            SSMConfig(scan_dtype=bad)
        with pytest.raises(ValueError, match="scan_dtype"):
            tops.selective_scan(*(torch.zeros(1, 2, 4),) * 2,
                                torch.zeros(4, 4), *(torch.zeros(1, 2, 4),)
                                * 2, None, bad)


def _cfgs(sd, **kw):
    """Jamba's f32 SMOKE config without experts at scan_dtype ``sd``, in
    both packages."""
    jc, tc = j_get_config(JAMBA, smoke=True), t_get_config(JAMBA, smoke=True)
    jc = jc.with_overrides(moe=None, **kw)
    tc = tc.with_overrides(moe=None, **kw)
    return (jc.with_overrides(ssm=dataclasses.replace(jc.ssm, scan_dtype=sd)),
            tc.with_overrides(ssm=dataclasses.replace(tc.ssm, scan_dtype=sd)))
