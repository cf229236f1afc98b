"""Finding/Rule records and the rule catalogue (the port's copy of
``repro/analysis/check/findings.py``: the same twelve rule ids, the texts
reworded for torch and CUDA).

Severity policy: ``error`` findings fail the gate unconditionally;
``warning`` findings fail it too unless suppressed. The split exists so
consumers (report JSON, editors) can rank them.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict


class Severity(str, enum.Enum):
    ERROR = "error"
    WARNING = "warning"


@dataclass(frozen=True)
class Rule:
    rule_id: str
    severity: Severity
    title: str
    rationale: str


@dataclass(frozen=True)
class Finding:
    rule_id: str
    severity: Severity
    loc: str                     # "file:line" or "entry:<name>" / "kernel:<name>"
    message: str
    fix_hint: str = ""
    suppressed: bool = False

    def format(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return (f"{self.loc}: {self.severity.value} {self.rule_id}{tag}: "
                f"{self.message}"
                + (f"\n    hint: {self.fix_hint}" if self.fix_hint else ""))


_R = Rule
RULES: Dict[str, Rule] = {r.rule_id: r for r in [
    # -- Pass 1: aten numerics (dispatch pass) ----------------------------
    _R("NUM001", Severity.ERROR,
       "low-precision contraction without an f32 result",
       "A matmul/einsum/mm whose operands are bf16/fp16/fp8 and whose "
       "result is not f32 rounds the accumulated sum to the input type; "
       "the paper's zeroth-order stats lose digits to it. Widen the "
       "operands first, or use a kernel that returns f32."),
    _R("NUM002", Severity.ERROR,
       "LU-based inverse/solve in an entry point",
       "torch.linalg.solve/inv/lu_factor/slogdet/det (and their _ex "
       "variants) run a pivoted LU. All covariances in this codebase are "
       "SPD; the sanctioned path is torch.linalg.cholesky + "
       "cholesky_solve / solve_triangular, which is backward-stable where "
       "LU pivoting on near-singular covariances is not."),
    _R("NUM003", Severity.ERROR,
       "frame-axis reduction not dominated by the mask",
       "A reduction over the frame axis whose operand depends on the "
       "features but not on the validity mask silently folds padding "
       "frames into sufficient statistics."),
    _R("NUM004", Severity.ERROR,
       "float64 leak",
       "A float64 tensor in an entry point doubles bandwidth and leaves "
       "the f32 path every kernel is written for; f64 is host-side "
       "only."),
    # -- Pass 2: CUDA kernel metadata (kernel pass) -----------------------
    _R("KRN001", Severity.ERROR,
       "grid does not cover the extent",
       "A grid axis whose blocks times tile fall short of the extent it "
       "walks leaves a ragged edge unread and unwritten; a kernel that "
       "does not mask ragged edges needs extents that divide its tiles."),
    _R("KRN002", Severity.ERROR,
       "output write-write race or coverage gap",
       "Two blocks writing the same output tile outside a declared "
       "reduction axis race; an output tile (or pair run) no block writes "
       "is left uninitialised."),
    _R("KRN003", Severity.ERROR,
       "async-copy ring discipline violation",
       "cp.async copies must be committed (commit_group) and waited "
       "(wait_group leaving at most stages - 2 groups in flight before a "
       "slab is read), with ring slots indexed modulo the stages; TMA "
       "loads need an mbarrier armed with their bytes (expect_tx), a wait "
       "on its phase, and a release of the slot before reuse. Else the "
       "kernel reads in-flight data or deadlocks."),
    _R("KRN004", Severity.WARNING,
       "shared memory over the block budget",
       "A block asking for more dynamic shared memory than the card lets "
       "it opt in to (shared_memory_per_block_optin: 232,448 bytes on the "
       "H100) is refused at launch."),
    # -- Pass 3: source AST (source pass) ----------------------------------
    _R("SRC001", Severity.ERROR,
       "torch.linalg.inv call",
       "Explicit matrix inverse is never the sanctioned path; use "
       "cholesky_solve / solve_triangular against the factorisation."),
    _R("SRC002", Severity.WARNING,
       "literal manual_seed outside tests",
       "A hard-coded manual_seed(<literal>) in library/launch code bakes a "
       "seed into production behaviour; thread the generator from the "
       "caller or suppress where the fixed seed is the documented "
       "contract."),
    _R("SRC003", Severity.ERROR,
       "host synchronisation inside a captured or compiled body",
       ".item()/.cpu()/float() on a tensor inside a body given to CUDA-"
       "graph capture or torch.compile forces a device sync (or breaks "
       "the capture or the graph); keep host reads outside it."),
    _R("DET001", Severity.WARNING,
       "unordered exit reduction where bit-exactness is claimed",
       "exit_reduce='psum' reduces in arrival order; streaming-session "
       "equivalence tests require exit_reduce='ordered'."),
]}


def make_finding(rule_id: str, loc: str, message: str,
                 fix_hint: str = "", suppressed: bool = False) -> Finding:
    rule = RULES[rule_id]
    return Finding(rule_id=rule_id, severity=rule.severity, loc=loc,
                   message=message, fix_hint=fix_hint, suppressed=suppressed)
