"""Lowering without a cluster (``launch/dryrun.py``,
``ivector_cell.lower_cell``, ``launch/mesh.fake_world`` and
``make_production_mesh``) on the CPU,
against the JAX package and against gloo ranks that ran.

- ``get_shape`` and ``ARCH_IDS`` are the reference's; the
  production meshes have its shapes, axis names and coordinates (a JAX
  subprocess with 512 fake devices gives them).
- ``op_cost``'s window rule against ``repro.analysis.hlo_cost`` on the same
  shapes: a gather's bytes equal the jitted JAX gather's whole program,
  an in-place scatter's 3 x its update the reference's count of an update
  window (a dynamic-update-slice; its ``scatter`` reads the index array as
  operand 1, which is pinned here as the reference does it).
- The live-bytes tracker's peak equals a hand count.
- Every rung lowers on meta tensors without ``torch.unique`` or a kernel
  launch; a lowered call counts what the same call counts on the CPU.
- A (2, 2) lowering in a fake world moves, rank by rank, the collective
  bytes that four gloo ranks count for the same call.
- The full-scale rows (256 and 512 ranks) are pinned; ``chip_smoke.py``
  phase 12 holds the card's rows to ``PINS``, read from this file.

Counts are integers in floats, held exactly.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.analysis.hlo_cost import HloCostModel, analyze_hlo  # noqa: E402
from repro.configs.ivector_tvm import CONFIG as J_CONFIG  # noqa: E402
from repro.launch import ivector_cell as JIC  # noqa: E402
from repro.launch import mesh as JMS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.analysis import op_cost  # noqa: E402
from repro_torch.configs.ivector_tvm import CONFIG, SMOKE  # noqa: E402
from repro_torch.kernels import gmm_align as tga  # noqa: E402
from repro_torch.kernels import gmm_loglik as tgl  # noqa: E402
from repro_torch.kernels import gmm_rescore as tgr  # noqa: E402
from repro_torch.kernels import bw_stats as tbw  # noqa: E402
from repro_torch.kernels import tvm_estep as tte  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import ivector_cell as IC  # noqa: E402
from repro_torch.launch import mesh as MS  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_ranks as RK  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

# rank 0's counts of ivector-tvm x train_4k lowered at CONFIG: flops,
# bytes, collective bytes (by op: an all-reduce crosses the links twice)
# and peak memory a device (its inputs plus the live peak). chip_smoke.py
# phase 12 reads this literal.
PINS = {
    "single": {
        "flops_per_device": 665579732992.0,
        "bytes_per_device": 41956027396.0,
        "coll_bytes_per_device": 716636312.0,
        "collectives": {"all-gather": 184329216.0,
                        "all-reduce": 532307096.0},
        "peak_memory_per_device": 8755459212.0,
    },
    "multi": {
        "flops_per_device": 356393590784.0,
        "bytes_per_device": 28317754372.0,
        "coll_bytes_per_device": 446709912.0,
        "collectives": {"all-gather": 121414656.0,
                        "all-reduce": 325295256.0},
        "peak_memory_per_device": 6905472576.0,
    },
}


# ---------------------------------------------------------------------------
# Configs and meshes against the reference
# ---------------------------------------------------------------------------


def test_shapes_and_arch_ids_are_the_reference_s():
    assert [vars(s) for s in TC.ALL_SHAPES] == \
        [vars(s) for s in JC.ALL_SHAPES]
    for s in JC.ALL_SHAPES:
        assert vars(TC.get_shape(s.name)) == vars(JC.get_shape(s.name))
    assert TC.ARCH_IDS == JC.ARCH_IDS
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert vars(getattr(TC, name)) == vars(getattr(JC, name))
    with pytest.raises(KeyError) as want:
        JC.get_shape("train_8k")
    with pytest.raises(KeyError) as got:
        TC.get_shape("train_8k")
    assert str(got.value) == str(want.value)


RANKS = (0, 1, 17, 255, 300, 511)
MESH_SCRIPT = """
import json
import numpy as np
from repro.launch.mesh import make_production_mesh
out = {}
for mp in (False, True):
    m = make_production_mesh(multi_pod=mp)
    ids = np.vectorize(lambda d: d.id)(m.devices)
    out[str(mp)] = {"shape": list(ids.shape), "axes": list(m.axis_names),
                    "coords": {str(r): np.argwhere(ids == r)[0].tolist()
                               for r in %r if r < ids.size}}
print(json.dumps(out))
""" % (RANKS,)


def test_production_meshes_are_the_reference_s():
    """Shapes, axis names and the coordinates of several ranks of both
    production meshes equal the JAX ones on 512 fake devices; a fake
    world leaves no process group and no mesh behind."""
    env = JMS.fake_device_env(512)
    env["PYTHONPATH"] = str(REPO / "src")
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "-c", MESH_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    before = dict(MS._MESHES)
    for mp in (False, True):
        w = want[str(mp)]
        n = int(np.prod(w["shape"]))
        for r in RANKS:
            if r >= n:
                continue
            with MS.fake_world(n, rank=r):
                mesh = MS.make_production_mesh(multi_pod=mp)
                assert list(mesh.shape) == w["shape"]
                assert list(mesh.axis_names) == w["axes"]
                assert list(mesh.coords) == w["coords"][str(r)]
                assert mesh.rank == r and mesh.device.type == "meta"
                assert mesh.backend == "fake"
                assert dist.get_world_size(mesh.groups["model"]) == 16
                assert dist.get_world_size(mesh.data_group) == n // 16
            assert not dist.is_initialized()
    assert MS._MESHES == before


def test_fake_world_refusals():
    with MS.fake_world(4):
        with pytest.raises(RuntimeError, match="already initialised"):
            with MS.fake_world(4):
                pass
        with pytest.raises(ValueError, match="meta"):
            MS.make_local_mesh(2, 2, device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="fake_world"):
        MS.make_production_mesh()


def test_fake_collectives_are_counted_on_meta():
    """all_reduce and all_gather go through the fake groups on meta
    tensors and are counted in Mesh.comm, Mesh.by_op and the counter."""
    with MS.fake_world(4, rank=3):
        mesh = MS.make_local_mesh(2, 2)
        assert mesh.coords == (1, 1)
        t = torch.empty(5, 3, device="meta")
        with op_cost.OpCounter(mesh) as cnt:
            MS.all_reduce(mesh, t, mesh.data_group, "exit")
            got = MS.all_gather(mesh, t, mesh.groups["model"], "model")
    assert [g.shape for g in got] == [(5, 3), (5, 3)]
    assert mesh.by_op == {"all-reduce": [1, 60], "all-gather": [1, 60]}
    assert mesh.comm == {"exit": [1, 60, 0.0], "model": [1, 60, 0.0]}
    assert cnt.coll == {"all-reduce": 120.0, "all-gather": 60.0}
    # as HBM bytes: the all-reduce reads and writes its tensor, the
    # all-gather reads its input and writes the two gathered
    assert cnt.by_op["allreduce_"][2] == 120
    assert cnt.by_op["allgather_"][2] == 60 + 120


# ---------------------------------------------------------------------------
# op_cost: the window rule against hlo_cost, the live-bytes tracker
# ---------------------------------------------------------------------------

T_SHAPE, N_IDS = (2048, 5184), 1000


def test_gather_bytes_equal_hlo_cost():
    """t[idx] with t [2048, 5184] f32 and 1,000 int32 ids: 2 x the output
    plus the indices, the whole jitted JAX program's bytes."""
    comp = jax.jit(lambda t, i: t[i]).lower(
        jax.ShapeDtypeStruct(T_SHAPE, jnp.float32),
        jax.ShapeDtypeStruct((N_IDS,), jnp.int32)).compile()
    want = analyze_hlo(comp.as_text())["bytes"]
    t = torch.empty(T_SHAPE, device="meta")
    idx = torch.empty(N_IDS, dtype=torch.int32, device="meta")
    with op_cost.OpCounter() as cnt:
        t[idx]
    assert cnt.bytes == want == 2 * N_IDS * T_SHAPE[1] * 4 + N_IDS * 4
    with op_cost.OpCounter() as cnt:
        t.index_select(0, idx)
        torch.gather(t, 1, torch.empty(T_SHAPE[0], 3, dtype=torch.int64,
                                       device="meta"))
    assert cnt.by_op["index_select"][2] == want
    assert cnt.by_op["gather"][2] == 2 * T_SHAPE[0] * 3 * 4 + \
        T_SHAPE[0] * 3 * 8


def _hlo_op_bytes(comp, opcode):
    """(bytes, operand-1 bytes) of the one ``opcode`` instruction of a
    compiled program, as ``HloCostModel`` counts it alone."""
    m = HloCostModel(comp.as_text())
    for name, ops in m.comps.items():
        for op in ops:
            if op.opcode == opcode:
                dt, shape = m._shape_of(name, op.operands[1])
                nbytes = int(np.prod(shape)) * {"f32": 4, "s32": 4}[dt]
                return m._op_cost(name, op).bytes, nbytes
    raise AssertionError(f"no {opcode} in the program")


def test_scatter_bytes_are_the_reference_window_rule():
    """An in-place scatter-add of [1000, 5184] rows into a [2048, 5184]
    accumulator counts 3 x its update (the window read, added to and
    written), ``hlo_cost._io_bytes``' rule for an update window: the
    reference's own count of a dynamic-update-slice of that window. Its
    ``scatter`` instruction reads operand 1, which for an XLA scatter is
    the index array: 3 x 4,000 bytes, pinned below as the reference
    counts it (the port keeps the window)."""
    f32 = jax.ShapeDtypeStruct(T_SHAPE, jnp.float32)
    upd = jax.ShapeDtypeStruct((N_IDS, T_SHAPE[1]), jnp.float32)
    dus = jax.jit(lambda t, s, u: jax.lax.dynamic_update_slice(
        t, u, (s, 0))).lower(f32, jax.ShapeDtypeStruct((), jnp.int32),
                             upd).compile()
    window, upd_bytes = _hlo_op_bytes(dus, "dynamic-update-slice")
    assert window == 3 * upd_bytes == 62_208_000
    sc = jax.jit(lambda t, i, u: t.at[i].add(u)).lower(
        f32, jax.ShapeDtypeStruct((N_IDS,), jnp.int32), upd).compile()
    sc_bytes, operand1 = _hlo_op_bytes(sc, "scatter")
    assert sc_bytes == 3 * operand1 == 3 * N_IDS * 4
    acc = torch.empty(T_SHAPE, device="meta")
    src = torch.empty(N_IDS, T_SHAPE[1], device="meta")
    ids = torch.empty(N_IDS, dtype=torch.int64, device="meta")
    with op_cost.OpCounter() as cnt:
        acc.index_add_(0, ids, src)
        acc.index_copy_(0, ids, src)
        acc.index_put_((ids,), src, accumulate=True)
        acc.scatter_add_(0, ids[:, None].expand(N_IDS, T_SHAPE[1]), src)
    for op in ("index_add_", "index_copy_", "index_put_", "scatter_add_"):
        assert cnt.by_op[op][2] == window, op
    # a scalar scatter writes index-many elements of the accumulator
    with op_cost.OpCounter() as cnt:
        acc.scatter_(1, torch.empty(T_SHAPE[0], 2, dtype=torch.int64,
                                    device="meta"), 0.0)
    assert cnt.by_op["scatter_"][2] == 3 * T_SHAPE[0] * 2 * 4


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_live_bytes_peak_is_the_hand_count(device):
    """Three tensors made inside the counter: a [1000] f32 product, a sum
    of it, a [2000] concatenation; the input made before is never
    counted, views add nothing, and the dead give their bytes back."""
    x = torch.ones(1000, device=device)
    with op_cost.OpCounter(live=True) as cnt:
        a = x * 2                      # 4,000 live
        b = a + 1                      # 8,000: a and b
        del a                          # 4,000
        v = b.view(10, 100)            # a view: nothing new
        c = torch.cat([b, v.reshape(-1)])   # 4,000 + 8,000 = 12,000
        del b, v                       # c alone: 8,000
        live_after = cnt.live.now
        del c
    assert cnt.peak_bytes == 12_000
    assert live_after == 8_000 and cnt.live.now == 0


# ---------------------------------------------------------------------------
# The lowering
# ---------------------------------------------------------------------------


def _no_launch(monkeypatch):
    """torch.unique and every CUDA wrapper of the i-vector path raise."""
    def boom(*a, **k):
        raise AssertionError("reached on a lowered call")
    monkeypatch.setattr(torch, "unique", boom)
    for mod, name in ((tgr, "gmm_rescore"), (tga, "gmm_rescore_fused"),
                      (tga, "gmm_align"), (tgl, "gmm_loglik"),
                      (tbw, "bw_stats"), (tte, "tvm_estep_l"),
                      (tte, "tvm_estep_a")):
        monkeypatch.setattr(mod, name, boom)


LOWER_CFG = SMOKE.with_overrides(update_sigma=True, estep="packed")


@pytest.mark.parametrize("rescore", ["sparse", "fused", "dense"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 2)])
def test_every_rung_lowers_on_meta(monkeypatch, rescore, shape):
    """On one rank and on a model-sharded fake mesh, each rung lowers
    with no torch.unique and no kernel launch; the rescore regions that
    read ids count from the bound and are listed apart."""
    _no_launch(monkeypatch)
    cfg = LOWER_CFG.with_overrides(rescore=rescore)
    if shape == (1, 1):
        cnt = IC.lower_step(cfg, MS.Mesh(MS.AXES, shape, (0, 0),
                                         torch.device("meta")))
    else:
        with MS.fake_world(2, rank=1):
            cnt = IC.lower_step(cfg, MS.make_local_mesh(*shape))
        assert cnt.coll_bytes > 0
    assert cnt.flops > 0 and cnt.bytes > 0 and cnt.peak_bytes > 0
    bound = {"sparse": {"gmm_rescore"}, "dense": set(),
             "fused": {"gmm_align" if shape == (1, 1)
                       else "gmm_rescore_fused"}}[rescore]
    assert set(cnt.id_bound) == bound
    assert {"bw_stats", "tvm_estep_l", "tvm_estep_a"} <= set(cnt.kernels)


@pytest.mark.parametrize("rescore", ["sparse", "fused", "dense"])
def test_lowered_counts_equal_the_cpu_run(rescore):
    """em_macro_step on real CPU tensors and the same call lowered on
    meta: the same flops, bytes and peak, but for the regions counted
    from a bound on their ids, which count at least the CPU's."""
    cfg = LOWER_CFG.with_overrides(rescore=rescore, utts_per_batch=8,
                                   frames_per_utt=40)
    C, D, R = cfg.n_components, cfg.feat_dim, cfg.ivector_dim
    rng = np.random.default_rng(5)
    a = rng.standard_normal((C, D, D)).astype(np.float32) * 0.3
    covs = torch.tensor(np.einsum("cij,ckj->cik", a, a) + np.eye(D),
                        dtype=torch.float32)
    prior = torch.zeros(R)
    prior[0] = cfg.prior_offset
    args = (torch.full((C,), 1.0 / C),
            torch.tensor(rng.standard_normal((C, D)), dtype=torch.float32),
            covs, torch.tensor(0.1 * rng.standard_normal((C, D, R)),
                               dtype=torch.float32), covs, prior,
            torch.tensor(rng.standard_normal((8, 40, D)),
                         dtype=torch.float32))
    mesh = MS.make_local_mesh(device="cpu")
    with op_cost.OpCounter(mesh, live=True) as cpu:
        IC.em_macro_step(cfg, mesh, *args, utt_chunk=4)
    low = IC.lower_step(cfg, MS.Mesh(MS.AXES, (1, 1), (0, 0),
                                     torch.device("meta")), utt_chunk=4)
    assert cpu.by_op == low.by_op
    assert cpu.peak_bytes == low.peak_bytes
    for k, (calls, fl, by) in low.kernels.items():
        c = cpu.kernels[k]
        assert c[0] == calls
        if k in low.id_bound:
            assert fl >= c[1] and by >= c[2]
        else:
            assert [fl, by] == c[1:], k


def test_fake_lowering_moves_what_gloo_ranks_move():
    """A (2, 2) SMOKE em_macro_step: every rank of a fake world of 4
    counts, by collective, the calls and bytes that rank counts in a
    spawned gloo world of 4 (threads capped)."""
    cfg = LOWER_CFG.with_overrides(utts_per_batch=16, frames_per_utt=40)
    got = MS.run_ranks(RK.macro_by_op, 4, args=(cfg, 4), device="cpu",
                       timeout=240, threads=1)
    for r in range(4):
        with MS.fake_world(4, rank=r):
            mesh = MS.make_local_mesh(2, 2)
            IC.lower_step(cfg, mesh, utt_chunk=4)
            assert {k: list(v) for k, v in mesh.by_op.items()} == got[r]
    assert set(got[0]) == {"all-gather", "all-reduce"}


@pytest.mark.parametrize("tag", ["single", "multi"])
def test_production_rows_are_pinned(tag):
    """ivector-tvm x train_4k at CONFIG on 16 x 16 and 2 x 16 x 16 lowers
    in under 60 s here; its counts are PINS."""
    cnt, row = dryrun.lower_cell("ivector-tvm", "train_4k", tag == "multi")
    assert row["status"] == "ok"
    assert row["lower_seconds"] < 60
    assert row["chips"] == (512 if tag == "multi" else 256)
    assert row["mesh"] == ("2x16x16" if tag == "multi" else "16x16")
    assert {k: row[k] for k in PINS[tag]} == PINS[tag]
    assert row["model_flops"] == IC.model_flops(CONFIG, 8192)
    assert set(row["id_bound"]) == {"gmm_rescore"}
    # the mesh's own count: an all-reduce's bytes once
    assert {k: v[1] * (2 if k == "all-reduce" else 1)
            for k, v in row["mesh_by_op"].items()} == row["collectives"]
    # the inputs every rank holds (the whole model and batch) on top of
    # the step's own live peak, as the reference's argument + temp bytes
    inputs = sum(t.numel() * t.element_size()
                 for t in IC.input_structs(CONFIG).values())
    assert row["peak_memory_per_device"] == inputs + cnt.peak_bytes
    assert row["peak_memory_per_device"] < 80e9


@pytest.mark.parametrize("rescore", ["dense", "sparse"])
def test_model_flops_equal_the_reference(rescore):
    """The analytic model of a macro-step at the paper's batch. The fused
    rung differs by design: the reference counts the union of rows its TPU
    autotuner picks, the port the K rows its CUDA kernel scores."""
    want = JIC.model_flops(J_CONFIG.with_overrides(rescore=rescore), 8192)
    assert IC.model_flops(CONFIG.with_overrides(rescore=rescore),
                          8192) == want


@pytest.mark.parametrize("flags,meshes", [
    ([], ["single", "multi"]), (["--single-pod-only"], ["single"]),
    (["--multi-pod-only"], ["multi"]), (["--multipod"], ["multi"])])
def test_dryrun_cli_mesh_flags(tmp_path, flags, meshes):
    """--arch/--shape writes one row for each mesh the flags select
    (--multipod is --multi-pod-only, as in the reference)."""
    dryrun.main(["--arch", "phi3-medium-14b", "--shape", "train_4k",
                 "--out", str(tmp_path), *flags])
    got = sorted(p.stem.split("__")[2] for p in tmp_path.glob("*.json"))
    assert got == sorted(meshes)


def test_dryrun_cli_all(tmp_path):
    """--all writes a row a cell: ivector-tvm train_4k 'ok' on both
    meshes, its other shapes 'skipped' with the reason; every LM cell
    lowered at full width, cut to one layer (``--layers 1``, four cells at
    a time), 'ok' with counts, or 'skipped' with the reason
    ``shape_applicability`` gives (long_500k for the quadratic archs);
    exit 0 and no 'error' row."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--layers", "1", "--jobs", "4", "--out", str(tmp_path)], env=env,
        capture_output=True, text=True, timeout=300, cwd=str(REPO))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    rows = {p.stem: json.loads(p.read_text())
            for p in tmp_path.glob("*.json")}
    assert len(rows) == len(TC.ARCH_IDS) * len(TC.ALL_SHAPES) * 2
    for key, row in rows.items():
        arch, shape = key.split("__")[:2]
        if arch == "ivector-tvm":
            if shape == "train_4k":
                tag = "multi" if row["mesh"] == "2x16x16" else "single"
                assert row["status"] == "ok"
                assert {k: row[k] for k in PINS[tag]} == PINS[tag]
            else:
                assert row["status"] == "skipped"
                assert "one EM macro-step" in row["reason"], row
            continue
        cfg = TC.get_config(arch)
        ok, why = cfg.shape_applicability(TC.get_shape(shape))
        if ok:
            assert row["status"] == "ok", row
            assert row["flops_per_device"] > 0 and row["layers"] >= 1
            assert row["bytes_per_device"] > 0
            assert row["coll_bytes_per_device"] > 0, row
        else:
            assert row["status"] == "skipped" and row["reason"] == why
    assert "done; 0 errors" in res.stdout
