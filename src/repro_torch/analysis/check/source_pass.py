"""Pass 3: source AST lint (SRC001-SRC003, DET001), the reference's pass
(``repro/analysis/check/source_pass.py``) with torch spellings.

Pure-syntax checks that need no run, so they catch hazards in code paths
no entry point reaches (launch scripts, tools, dead branches):

  * SRC001 ``torch.linalg.inv`` (or ``inv_ex``, ``torch.inverse``);
  * SRC002 ``manual_seed(<literal>)`` outside tests;
  * SRC003 ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
    ``float()``, ``int()`` or ``bool()`` inside a body given to CUDA-graph
    capture (``with torch.cuda.graph(...)``,
    ``torch.cuda.make_graphed_callables``) or to ``torch.compile`` /
    ``torch.jit``;
  * DET001 ``exit_reduce=`` anything but ``'ordered'``.

Suppression: a comment ``# repro-check: disable=RULE`` (comma-separated
for several rules) on the offending line or the line directly above it
marks the finding suppressed; suppressed findings are reported but do
not fail the run.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Set, Union

from repro_torch.analysis.check.findings import Finding, make_finding

_SUPPRESS_RE = re.compile(r"#\s*repro-check:\s*disable=([A-Z0-9, ]+)")

_HOST_SYNC_NAMES = {"float", "int", "bool"}
_HOST_SYNC_ATTRS = {"item", "cpu", "tolist", "numpy"}
# calls whose function arguments run captured or compiled
_CAPTURING = ("torch.compile", "make_graphed_callables", "jit.script",
              "jit.trace")
# a ``with`` over one of these captures its body
_CAPTURE_CONTEXTS = ("cuda.graph",)


def _suppressions(lines: Sequence[str]) -> Dict[int, Set[str]]:
    """1-based line -> set of rule ids disabled at that line."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        out.setdefault(i, set()).update(rules)       # same line
        out.setdefault(i + 1, set()).update(rules)   # the line below
    return out


def _is_test_file(path: Path) -> bool:
    return path.name.startswith("test_") or "tests" in path.parts


def _dotted(node) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _capturing(name: str) -> bool:
    return name.endswith(_CAPTURING)


class _Lint(ast.NodeVisitor):
    def __init__(self, path: Path, lines: Sequence[str]):
        self.path = path
        self.suppress = _suppressions(lines)
        self.findings: List[Finding] = []
        self.is_test = _is_test_file(path)
        # names of functions handed to capture / compilation in this module
        self.traced_names: Set[str] = set()
        self._depth = 0

    def _emit(self, rule_id: str, node: ast.AST, message: str,
              fix_hint: str = ""):
        line = getattr(node, "lineno", 0)
        suppressed = rule_id in self.suppress.get(line, set())
        self.findings.append(make_finding(
            rule_id, f"{self.path}:{line}", message, fix_hint,
            suppressed=suppressed))

    def collect_traced(self, tree: ast.AST):
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and _capturing(_dotted(node.func)):
                for arg in node.args:
                    if isinstance(arg, ast.Name):
                        self.traced_names.add(arg.id)

    def _traced_body(self, node):
        self._depth += 1
        self.generic_visit(node)
        self._depth -= 1

    def _handle_def(self, node):
        traced = node.name in self.traced_names
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if _capturing(_dotted(target)):
                traced = True
        if traced:
            self._traced_body(node)
        else:
            self.generic_visit(node)

    visit_FunctionDef = _handle_def
    visit_AsyncFunctionDef = _handle_def

    def visit_With(self, node: ast.With):
        if any(isinstance(it.context_expr, ast.Call)
               and _dotted(it.context_expr.func).endswith(_CAPTURE_CONTEXTS)
               for it in node.items):
            self._traced_body(node)
        else:
            self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        name = _dotted(node.func)
        tail = name.rsplit(".", 1)[-1]

        if ((tail in ("inv", "inv_ex") and ".linalg." in f".{name}.")
                or name == "torch.inverse"):
            self._emit("SRC001", node,
                       f"explicit matrix inverse '{name}(...)'",
                       "factor once (torch.linalg.cholesky) and use "
                       "cholesky_solve / solve_triangular")

        if tail == "manual_seed" and not self.is_test:
            if node.args and isinstance(node.args[0], ast.Constant):
                self._emit("SRC002", node,
                           f"hard-coded manual_seed({node.args[0].value!r}) "
                           "outside tests",
                           "thread the generator from the caller, or "
                           "suppress where the fixed seed is the contract")

        if self._depth:
            if (isinstance(node.func, ast.Name)
                    and node.func.id in _HOST_SYNC_NAMES and node.args):
                self._emit("SRC003", node,
                           f"'{node.func.id}()' on a tensor inside a "
                           "captured or compiled body forces a host sync",
                           "keep host conversions outside the captured "
                           "region")
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _HOST_SYNC_ATTRS):
                self._emit("SRC003", node,
                           f"'{name}(...)' inside a captured or compiled "
                           "body forces a host sync",
                           "return the tensor and read it after the "
                           "captured call")

        for kw in node.keywords:
            if (kw.arg == "exit_reduce"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value != "ordered"):
                self._emit("DET001", node,
                           f"exit_reduce={kw.value.value!r}: arrival-order "
                           "reduction breaks bit-exact session replay",
                           "use exit_reduce='ordered' (or suppress where "
                           "throughput deliberately wins)")

        self.generic_visit(node)


def check_source(paths: Union[str, Path, Iterable]) -> List[Finding]:
    """Lint ``*.py`` under the given file/dir paths (SRC/DET rules)."""
    if isinstance(paths, (str, Path)):
        paths = [paths]
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    findings: List[Finding] = []
    for f in files:
        try:
            text = f.read_text()
            tree = ast.parse(text, filename=str(f))
        except (OSError, SyntaxError) as e:
            findings.append(make_finding(
                "SRC003", f"{f}:0", f"unparseable source: {e}",
                "fix the syntax error"))
            continue
        lint = _Lint(f, text.splitlines())
        lint.collect_traced(tree)
        lint.visit(tree)
        findings.extend(lint.findings)
    return findings
