"""The port's check passes (``repro_torch.analysis.check``) on the CPU:
a twin of every rule fixture of ``tests/test_check.py`` that plants the
same kind of fault and must give the same rule id, the clean-repo gate,
and the port's entries against the reference's (the same (entry, rule)
set: none).

NUM004's twin is held to the rule's text (a float64 tensor in an entry);
the JAX fixture ``test_num004_f64_leak`` is a reference caveat that fails
on this container (ROADMAP Queue 3).
"""
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.analysis.check import check_jaxpr  # noqa: E402
from repro.analysis.check import entries as jentries  # noqa: E402
from repro_torch.analysis.check import (  # noqa: E402
    check_dispatch, check_kernel, check_source, run_all)
from repro_torch.analysis.check.cli import report_json  # noqa: E402
from repro_torch.analysis.check import entries as tentries  # noqa: E402
from repro_torch.kernels import ops, registry  # noqa: E402

f32 = torch.float32
bf16 = torch.bfloat16
REPO = pathlib.Path(__file__).resolve().parents[1]


def _ids(findings, unsuppressed_only=True):
    return sorted(f.rule_id for f in findings
                  if not (unsuppressed_only and f.suppressed))


# ---------------------------------------------------------------------------
# Pass 1 twins: aten numerics (the jaxpr rules of tests/test_check.py)
# ---------------------------------------------------------------------------


class TestDispatchRules:
    def test_num001_bf16_dot_without_preferred(self):
        a = torch.zeros((8, 16), dtype=bf16)
        b = torch.zeros((16, 4), dtype=bf16)
        found = check_dispatch(lambda x, y: x @ y, a, b)
        assert _ids(found) == ["NUM001"]

    def test_num001_mixed_promotion_is_clean(self):
        # torch does not promote a bf16 x f32 product: the port widens the
        # bf16 operand first, and the product is f32
        a = torch.zeros((8, 16), dtype=bf16)
        b = torch.zeros((16, 4), dtype=f32)
        found = check_dispatch(lambda x, y: x.to(f32) @ y, a, b)
        assert _ids(found) == []

    def test_num001_downcast_before_dot(self):
        a = torch.zeros((8, 16), dtype=f32)
        b = torch.zeros((16, 4), dtype=f32)
        found = check_dispatch(lambda x, y: x.to(bf16) @ y.to(bf16), a, b)
        assert "NUM001" in _ids(found)

    def test_num001_clean_with_preferred(self):
        # the port's f32-accumulating bf16 product is the packed E-step
        # kernel (ops.tvm_estep_l, dtype='bfloat16'): f32 out on both
        # devices
        n = torch.zeros((16, 8), dtype=f32)
        up = torch.zeros((8, 36), dtype=f32)
        found = check_dispatch(
            lambda x, y: ops.tvm_estep_l(x, y, dtype="bfloat16"), n, up)
        assert _ids(found) == []

    def test_num002_inv(self):
        found = check_dispatch(torch.linalg.inv, torch.eye(4) * 2.0)
        assert "NUM002" in _ids(found)

    def test_num002_solve_and_slogdet(self):
        m = torch.eye(4) * 2.0
        v = torch.ones((4,))
        assert "NUM002" in _ids(check_dispatch(torch.linalg.solve, m, v))
        assert "NUM002" in _ids(check_dispatch(
            lambda x: torch.linalg.slogdet(x)[1], m))
        assert "NUM002" in _ids(check_dispatch(torch.linalg.det, m))

    def test_num002_cholesky_sanctioned(self):
        m = torch.eye(4) * 2.0
        v = torch.ones((4, 1))
        found = check_dispatch(
            lambda a, b: torch.cholesky_solve(b, torch.linalg.cholesky(a)),
            m, v)
        assert _ids(found) == []

    def test_num003_unmasked_frame_mean(self):
        F = 97
        found = check_dispatch(lambda feats, mask: feats.mean(dim=0),
                               torch.zeros((F, 6)), torch.ones((F,)),
                               input_roles=("feats", "mask"), frame_extent=F)
        assert "NUM003" in _ids(found)

    def test_num003_masked_is_clean(self):
        F = 97

        def fn(feats, mask):
            z = torch.where(mask[:, None] > 0, feats, 0.0)
            return z.sum(dim=0) / torch.clamp(mask.sum(), min=1.0)

        found = check_dispatch(fn, torch.zeros((F, 6)), torch.ones((F,)),
                               input_roles=("feats", "mask"), frame_extent=F)
        assert _ids(found) == []

    def test_num003_inactive_without_mask_input(self):
        found = check_dispatch(lambda feats: feats.mean(dim=0),
                               torch.zeros((97, 6)), input_roles=("feats",),
                               frame_extent=97)
        assert _ids(found) == []

    def test_num003_sees_into_scan(self):
        # the port's scan is a Python loop over chunks: each chunk's fold
        # over its frames is seen as it runs
        F = 97

        def fn(feats, mask):
            out = torch.zeros((6,))
            for c in range(feats.shape[0]):
                out = out + feats[c].sum(dim=0)
            return out

        found = check_dispatch(fn, torch.zeros((3, F, 6)),
                               torch.ones((3, F)),
                               input_roles=("feats", "mask"), frame_extent=F)
        assert "NUM003" in _ids(found)

    def test_num003_in_place_write_carries_the_mask(self):
        # a masked value written in place into a buffer: the buffer (and
        # the base it views) carry the mask
        F = 97

        def fn(feats, mask):
            buf = torch.zeros((2, F, 6))
            buf[0].copy_(feats * mask[:, None])
            return buf.sum(dim=1)

        found = check_dispatch(fn, torch.zeros((F, 6)), torch.ones((F,)),
                               input_roles=("feats", "mask"), frame_extent=F)
        assert _ids(found) == []

    def test_num004_f64_leak(self):
        found = check_dispatch(lambda v: (v.double() * 2.0).sum(),
                               torch.zeros((4,)))
        assert "NUM004" in _ids(found)

    def test_kernel_region_outputs_take_the_inputs_tags(self):
        # gmm_loglik's kernel region: its [F, C] output carries 'feats'
        # (not the mask), so an unmasked frame fold of it is flagged, and
        # masking it clears the finding
        F, C, D = 97, 8, 6
        const, lin = torch.zeros(C), torch.zeros(D, C)
        P = torch.eye(D).reshape(1, D * D).repeat(C, 1)

        def unmasked(x, m):
            return ops.gmm_loglik(x, const, lin, P).sum(dim=0)

        def masked(x, m):
            return (ops.gmm_loglik(x, const, lin, P) * m[:, None]).sum(dim=0)

        args = (torch.zeros((F, D)), torch.ones((F,)))
        kw = dict(input_roles=("feats", "mask"), frame_extent=F)
        assert _ids(check_dispatch(unmasked, *args, **kw)) == ["NUM003"]
        assert _ids(check_dispatch(masked, *args, **kw)) == []


# ---------------------------------------------------------------------------
# Pass 2 twins: CUDA kernel metadata
# ---------------------------------------------------------------------------


_CLEAN_CU = """
constexpr int STAGES = 3;
__global__ void k(const float* x, float* o, int n) {
  for (int s = 0; s < STAGES - 1; ++s) { cp_async16(o + s, x + s); cp_commit(); }
  for (int s = 0; s < n; ++s) {
    cp_wait<STAGES - 2>();
    cp_async16(o + (s % STAGES), x + s);
    cp_commit();
  }
}
"""


def _spec(tmp_path=None, *, describe=None, source=None, masks=True,
          reduction_axes=(), config=None):
    src = "fixture.cu"
    if source is not None:
        (tmp_path / src).write_text(source)
        src = str(tmp_path / src)     # an absolute path wins over CSRC
    return registry.KernelSpec(
        name="fixture", source=src, describe=describe,
        work=lambda cfg: (0.0, 0.0, "float32"),
        default_config=config or {}, main_config={},
        reduction_axes=reduction_axes, masks_ragged=masks)


def _inst(grid, axes, outputs=(), rings=(), smem=0):
    return registry.KernelInstance(grid=grid, threads=128, smem_bytes=smem,
                                   axes=axes, outputs=outputs, rings=rings)


class TestKernelRules:
    def test_krn001_indivisible_without_wrapper(self, tmp_path):
        def describe(cfg):
            return _inst((2,), (registry.Axis("frames", 100, 64),),
                         (registry.BlockMap("o", (100, 8), (64, 8),
                                            lambda i: (i, 0)),))

        found = check_kernel(_spec(tmp_path, describe=describe,
                                   source="", masks=False))
        assert "KRN001" in _ids(found)
        # the same geometry in a kernel that masks its ragged edge: clean
        found = check_kernel(_spec(tmp_path, describe=describe, source=""))
        assert "KRN001" not in _ids(found)

    def test_krn001_grid_short_of_the_extent(self, tmp_path):
        # floor instead of ceil: the ragged edge is never reached, masked
        # or not
        def describe(cfg):
            return _inst((1,), (registry.Axis("frames", 100, 64),))

        found = check_kernel(_spec(tmp_path, describe=describe, source=""))
        assert "KRN001" in _ids(found)

    def test_krn002_two_writers_race(self, tmp_path):
        def describe(cfg):
            return _inst((2, 2), (registry.Axis("rows", 128, 64),
                                  registry.Axis("cols", 128, 64)),
                         (registry.BlockMap("o", (128, 64), (64, 64),
                                            lambda i, j: (i, 0)),))

        found = check_kernel(_spec(tmp_path, describe=describe, source=""))
        assert "KRN002" in _ids(found)
        found = check_kernel(_spec(tmp_path, describe=describe, source="",
                                   reduction_axes=(1,)))
        assert "KRN002" not in _ids(found)

    def test_krn002_coverage_hole(self, tmp_path):
        def describe(cfg):
            return _inst((2,), (registry.Axis("rows", 128, 64),),
                         (registry.BlockMap("o", (128, 8), (64, 8),
                                            lambda i: (0, 0)),))

        found = check_kernel(_spec(tmp_path, describe=describe, source="",
                                   reduction_axes=(0,)))
        assert "KRN002" in _ids(found)

    def test_krn002_work_item_runs(self):
        # gmm_rescore's blocks take data-dependent runs of the pairs: the
        # kernel's cut partitions them; a run dropped, or a grid too small
        # for the cut, is flagged
        spec = registry.get("gmm_rescore")
        counts = [0, 130, 1, 0, 64, 5] + [0] * 250
        cfg = {"F": 25, "K": 8, "counts": counts}
        assert check_kernel(spec, cfg) == []
        inst = spec.instance(cfg)
        from repro_torch.analysis.check import kernel_pass as KP
        holed = registry.KernelInstance(
            grid=inst.grid, threads=inst.threads, smem_bytes=0,
            axes=inst.axes, runs=inst.runs[1:], run_extent=inst.run_extent)
        assert _ids(KP._check_races_and_coverage(spec, holed)) == ["KRN002"]
        small = registry.KernelInstance(
            grid=(len(inst.runs) - 1,), threads=inst.threads, smem_bytes=0,
            axes=inst.axes, runs=inst.runs, run_extent=inst.run_extent)
        assert _ids(KP._check_races_and_coverage(spec, small)) == ["KRN002"]

    def test_krn003_start_without_wait(self, tmp_path):
        leaky = _CLEAN_CU.replace("    cp_wait<STAGES - 2>();\n", "")

        def describe(cfg):
            return _inst((1,), (), rings=(registry.Ring("cp.async", 3),))

        found = check_kernel(_spec(tmp_path, describe=describe,
                                   source=leaky))
        assert "KRN003" in _ids(found)
        found = check_kernel(_spec(tmp_path, describe=describe,
                                   source=_CLEAN_CU))
        assert _ids(found) == []

    def test_krn003_undeclared_ring(self, tmp_path):
        def describe(cfg):
            return _inst((1,), ())

        found = check_kernel(_spec(tmp_path, describe=describe,
                                   source=_CLEAN_CU))
        assert "KRN003" in _ids(found)

    def test_krn003_ring_faults(self, tmp_path):
        """A wait that leaves the slab in flight, copies never committed,
        slots not indexed modulo the stages, stages that disagree with the
        source, and a TMA ring with no barrier armed or slot released."""
        def ring(kind, stages):
            return lambda cfg: _inst((1,), (),
                                     rings=(registry.Ring(kind, stages),))

        cases = (
            _CLEAN_CU.replace("STAGES - 2>", "STAGES - 1>"),
            _CLEAN_CU.replace("cp_commit();", ""),
            _CLEAN_CU.replace("(s % STAGES)", "s"),
        )
        for src in cases:
            found = check_kernel(_spec(tmp_path, describe=ring("cp.async", 3),
                                       source=src))
            assert _ids(found) == ["KRN003"], src
        found = check_kernel(_spec(tmp_path, describe=ring("cp.async", 4),
                                   source=_CLEAN_CU))
        assert _ids(found) == ["KRN003"]
        tma = """
        constexpr int STAGES = 2;
        void k() {
          bar_wait(empty + 8 * (j % STAGES), ((j / STAGES) & 1) ^ 1);
          bar_expect_tx(full, 4096);
          tma_load_2d(dst, &map, full, 0, 0);
          bar_wait(full + 8 * (j % STAGES), (j / STAGES) & 1);
          bar_arrive(empty + 8 * (j % STAGES));
        }
        """
        assert check_kernel(_spec(tmp_path, describe=ring("tma", 2),
                                  source=tma)) == []
        for fault in ("bar_expect_tx(full, 4096);",
                      "bar_arrive(empty + 8 * (j % STAGES));"):
            found = check_kernel(_spec(tmp_path, describe=ring("tma", 2),
                                       source=tma.replace(fault, "")))
            assert _ids(found) == ["KRN003"], fault

    def test_krn004_vmem_over_budget(self):
        # the whole-row instance keeping 16 frames' rows at C = 8192: the
        # score rows alone are 512 KB, above the block's 227 KB
        spec = registry.get("gmm_align")
        found = check_kernel(spec, {"F": 4096, "C": 8192, "D": 72,
                                    "K": 40, "rows": 16})
        assert "KRN004" in _ids(found)

    def test_registered_kernels_clean_at_defaults(self):
        for spec in registry.all_specs():
            found = check_kernel(spec)
            assert _ids(found) == [], (spec.name, [f.format()
                                                   for f in found])

    def test_registered_kernels_clean_at_main_configs(self):
        for spec in registry.all_specs():
            found = check_kernel(spec, spec.main_config)
            assert _ids(found) == [], (spec.name, [f.format()
                                                   for f in found])


# ---------------------------------------------------------------------------
# Pass 3 twins: source rules + suppression
# ---------------------------------------------------------------------------


def _lint(tmp_path, code, fname="mod.py"):
    p = tmp_path / fname
    p.write_text(code)
    return check_source(p)


class TestSourceRules:
    def test_src001_inv(self, tmp_path):
        found = _lint(tmp_path,
                      "import torch\n"
                      "def f(m):\n"
                      "    return torch.linalg.inv(m)\n")
        assert _ids(found) == ["SRC001"]

    def test_src002_manual_seed_literal(self, tmp_path):
        found = _lint(tmp_path,
                      "import torch\n"
                      "g = torch.Generator().manual_seed(0)\n")
        assert _ids(found) == ["SRC002"]

    def test_src002_skipped_in_tests(self, tmp_path):
        found = _lint(tmp_path,
                      "import torch\n"
                      "g = torch.Generator().manual_seed(0)\n",
                      fname="test_mod.py")
        assert _ids(found) == []

    def test_src003_host_sync_in_compiled_body(self, tmp_path):
        found = _lint(tmp_path,
                      "import torch\n"
                      "def body(x):\n"
                      "    return x * float(x.sum())\n"
                      "step = torch.compile(body)\n")
        assert _ids(found) == ["SRC003"]
        found = _lint(tmp_path,
                      "import torch\n"
                      "def run(g, x):\n"
                      "    with torch.cuda.graph(g):\n"
                      "        y = x.sum().item()\n"
                      "    return y\n")
        assert _ids(found) == ["SRC003"]

    def test_src003_host_sync_outside_traced_ok(self, tmp_path):
        found = _lint(tmp_path,
                      "def f(x):\n"
                      "    return float(x), x.cpu(), x.item()\n")
        assert _ids(found) == []

    def test_det001_psum_exit(self, tmp_path):
        found = _lint(tmp_path,
                      "def run(stream):\n"
                      "    return stream(exit_reduce='psum')\n")
        assert _ids(found) == ["DET001"]

    def test_suppression_comment(self, tmp_path):
        found = _lint(tmp_path,
                      "import torch\n"
                      "# repro-check: disable=SRC002\n"
                      "g = torch.manual_seed(0)\n")
        assert _ids(found) == []
        assert [f.rule_id for f in found if f.suppressed] == ["SRC002"]

    def test_suppression_trailing(self, tmp_path):
        found = _lint(tmp_path,
                      "def run(s):\n"
                      "    return s(exit_reduce='psum')"
                      "  # repro-check: disable=DET001\n")
        assert _ids(found) == []


# ---------------------------------------------------------------------------
# The gate: the port checks clean, as the reference does
# ---------------------------------------------------------------------------


class TestCleanPort:
    def test_port_runs_clean(self):
        report = run_all([str(REPO / "src" / "repro_torch")], device="cpu")
        bad = [f.format() for f in report["findings"] if not f.suppressed]
        assert report["unsuppressed"] == 0, "\n".join(bad)
        js = report_json(report)
        assert set(js) == {"rules", "suppressed", "unsuppressed", "wall_s"}
        assert js["unsuppressed"] == 0
        # the literal seeds and psum exits the reference suppresses too
        # (the sixth SRC002: launch/train.py's fixed seed, as the JAX
        # launcher's)
        assert sorted(f.rule_id for f in report["findings"]) == \
            ["DET001"] * 2 + ["SRC002"] * 6

    def test_entries_match_the_reference(self):
        """The same eight entries, and the same (entry, rule id) set as the
        JAX jaxpr pass over the reference's entries: none."""
        def findings(entries, check):
            return {(e.name, f.rule_id) for e in entries
                    for f in check(e.fn, *e.args, entry=e.name,
                                   input_roles=e.roles,
                                   frame_extent=e.frame_extent)}

        tj = tentries.build_entries("cpu")
        jj = jentries.build_entries()
        assert [e.name for e in tj] == [e.name for e in jj]
        assert [tuple(e.roles) for e in tj] == [tuple(e.roles) for e in jj]
        assert findings(tj, check_dispatch) == findings(jj, check_jaxpr) \
            == set()

    def test_cli_exit_codes(self, tmp_path):
        dirty = tmp_path / "dirty.py"
        dirty.write_text("import torch\n"
                         "def f(m):\n"
                         "    return torch.linalg.inv(m)\n")
        clean = tmp_path / "clean.py"
        clean.write_text("x = 1\n")
        env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
        for path, rc in ((dirty, 1), (clean, 0)):
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.analysis.check",
                 "--device", "cpu", str(path), "--rules", "SRC001"],
                env=env, capture_output=True, text=True, timeout=120,
                cwd=tmp_path)
            assert r.returncode == rc, r.stdout + r.stderr
        # no report file unless asked for
        assert sorted(p.name for p in tmp_path.iterdir()) == \
            ["clean.py", "dirty.py"]
