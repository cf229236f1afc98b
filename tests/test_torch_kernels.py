"""Parity of the PyTorch port's kernel entry points (``repro_torch.kernels``)
with the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The JAX
side runs its Pallas kernels in interpret mode (``ops.use_pallas(True)``);
the port's CPU path is the plain version the CUDA kernels are held against
on the card. Tolerance: 2e-5 relative and absolute in f32, as in
``tests/test_kernels.py`` (the same f32 products summed in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import gmm_loglik as tgl  # noqa: E402
from repro_torch.kernels import gmm_rescore as tgr  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import tvm_estep as tte  # noqa: E402

TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _precisions(rng, C, D):
    const = rng.standard_normal(C).astype(np.float32)
    lin = rng.standard_normal((D, C)).astype(np.float32)
    A = (0.3 * rng.standard_normal((C, D, D))).astype(np.float32)
    P = (np.einsum("cij,ckj->cik", A, A) + np.eye(D, dtype=np.float32))
    return const, lin, P.reshape(C, D * D).astype(np.float32)


@pytest.mark.parametrize("F,D,C,bf,bc", [
    (256, 8, 32, 128, 32),
    (300, 8, 32, 128, 32),    # ragged F
    (193, 6, 23, 64, 16),     # ragged F and C
])
def test_gmm_loglik_matches_pallas(F, D, C, bf, bc):
    rng = np.random.default_rng(F + C)
    x = rng.standard_normal((F, D)).astype(np.float32)
    const, lin, P = _precisions(rng, C, D)
    with jops.use_pallas(True):
        want = jops.gmm_loglik(jnp.asarray(x), jnp.asarray(const),
                               jnp.asarray(lin), jnp.asarray(P),
                               block_f=bf, block_c=bc)
    got = tops.gmm_loglik(_t(x), _t(const), _t(lin), _t(P))
    assert got.shape == (F, C) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("F,D,C,K", [
    (64, 8, 32, 5),
    (37, 6, 16, 16),          # ragged F, K == C
])
def test_gmm_rescore_matches_pallas(F, D, C, K):
    """Duplicate, boundary and out-of-range ids: both wrappers clip into
    [0, C) and score each slot independently."""
    rng = np.random.default_rng(F * K)
    x = rng.standard_normal((F, D)).astype(np.float32)
    const, lin, P = _precisions(rng, C, D)
    sel = rng.integers(0, C, size=(F, K)).astype(np.int32)
    sel[0, :] = sel[0, 0]                 # duplicates
    sel[1, 0], sel[1, -1] = 0, C - 1      # boundaries
    sel[2, 0], sel[2, -1] = -3, C + 5     # out of range: clipped
    with jops.use_pallas(True):
        want = jops.gmm_rescore(jnp.asarray(x), jnp.asarray(sel),
                                jnp.asarray(const), jnp.asarray(lin),
                                jnp.asarray(P), block_f=8)
    got = tops.gmm_rescore(_t(x), _t(sel), _t(const), _t(lin), _t(P))
    assert got.shape == (F, K)
    _close(got, want)
    # the cached pack gives the same answer as the unpacked operands
    pack = tref.rescore_pack(_t(const), _t(lin), _t(P))
    _close(pack, jref.rescore_pack(jnp.asarray(const), jnp.asarray(lin),
                                   jnp.asarray(P)))


def _estep_operands(rng, U, C, R):
    P = R * (R + 1) // 2
    n = rng.uniform(0.0, 5.0, size=(U, C)).astype(np.float32)
    Up = rng.standard_normal((C, P)).astype(np.float32)
    PPp = rng.standard_normal((U, P)).astype(np.float32)
    return n, Up, PPp


@pytest.mark.parametrize("U,C,R,blocks", [
    (16, 24, 10, dict(block_u=8, block_p=32, block_c=8)),
    (13, 21, 5, dict(block_u=8, block_p=8, block_c=8)),   # ragged U/C, odd P
])
def test_tvm_estep_matches_pallas(U, C, R, blocks):
    rng = np.random.default_rng(U * C + R)
    n, Up, PPp = _estep_operands(rng, U, C, R)
    with jops.use_pallas(True):
        want_l = jops.tvm_estep_l(jnp.asarray(n), jnp.asarray(Up), **blocks)
        want_a = jops.tvm_estep_a(jnp.asarray(n), jnp.asarray(PPp),
                                  **blocks)
    got_l = tops.tvm_estep_l(_t(n), _t(Up))
    got_a = tops.tvm_estep_a(_t(n), _t(PPp))
    assert got_l.shape == (U, R * (R + 1) // 2)
    assert got_a.shape == (C, R * (R + 1) // 2)
    _close(got_l, want_l)
    _close(got_a, want_a)


def test_tvm_estep_bf16_matches_jnp_path():
    """bf16 casts the inputs only; both sides widen them exactly and
    accumulate in f32, so they differ by f32 summation order alone
    (tolerance 2e-5, as for f32). The reference is the jnp path: the
    Pallas bf16 interpret path is a known-failing reference test."""
    rng = np.random.default_rng(7)
    n, Up, PPp = _estep_operands(rng, 40, 24, 10)
    with jops.use_pallas(False):
        want_l = jops.tvm_estep_l(jnp.asarray(n), jnp.asarray(Up),
                                  dtype="bfloat16")
        want_a = jops.tvm_estep_a(jnp.asarray(n), jnp.asarray(PPp),
                                  dtype="bfloat16")
    got_l = tops.tvm_estep_l(_t(n), _t(Up), dtype="bfloat16")
    got_a = tops.tvm_estep_a(_t(n), _t(PPp), dtype="bfloat16")
    assert got_l.dtype == torch.float32 and got_a.dtype == torch.float32
    _close(got_l, want_l)
    _close(got_a, want_a)
    # the knob changes the compute dtype, by a bf16-sized amount
    f32_l = tops.tvm_estep_l(_t(n), _t(Up))
    rel = float((got_l - f32_l).abs().max() / f32_l.abs().max())
    assert 0.0 < rel < 3e-2
    with pytest.raises(ValueError):
        tops.tvm_estep_l(_t(n), _t(Up), dtype="float16")


@pytest.mark.parametrize("R,block", [(7, 16), (40, 8)])
def test_tri_inverse_matches_jax(R, block):
    rng = np.random.default_rng(R)
    A = rng.standard_normal((3, R, R)).astype(np.float32)
    G = np.tril(A) * 0.1 + np.eye(R, dtype=np.float32) * 2.0
    want = jref.tri_inverse(jnp.asarray(G), block)
    got = tref.tri_inverse(_t(G), block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("R", [1, 6])
def test_pack_unpack_symmetric_match_jax(R):
    rng = np.random.default_rng(R)
    A = rng.standard_normal((2, R, R)).astype(np.float32)
    M = A + A.transpose(0, 2, 1)
    p = tref.pack_symmetric(_t(M))
    np.testing.assert_array_equal(
        p.numpy(), np.asarray(jref.pack_symmetric(jnp.asarray(M))))
    np.testing.assert_array_equal(tref.unpack_symmetric(p, R).numpy(), M)
    np.testing.assert_array_equal(
        tref._packed_index_map(R).numpy(),
        np.asarray(jref._packed_index_map(R)))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise: a CPU tensor never reaches a
    silent fallback inside them (the plain version is chosen in ops)."""
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tgl.gmm_loglik(x, torch.zeros(2), torch.zeros(3, 2),
                       torch.zeros(2, 9))
    with pytest.raises(ValueError, match="CUDA"):
        tgr.gmm_rescore(x, torch.zeros(4, 2, dtype=torch.int64),
                        torch.zeros(2, 13))
    with pytest.raises(ValueError, match="CUDA"):
        tte.tvm_estep_l(torch.zeros(2, 3), torch.zeros(3, 6))
    assert (tgl.gmm_loglik.launches, tgr.gmm_rescore.launches,
            tte.tvm_estep_l.launches) == (0, 0, 0)


def test_build_names_every_source():
    """Every CUDA source under csrc/ has its entry signatures, and its
    library name follows the source's hash into the ignored build dir."""
    sources = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert sources == set(_build.SIGNATURES)
    for name in sources:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"lib{name}_") and path.suffix == ".so"
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
