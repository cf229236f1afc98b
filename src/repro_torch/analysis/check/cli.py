"""The command line: ``python -m repro_torch.analysis.check [--device cpu]
[--rules ...] [--report FILE] [paths]``.

Runs the three passes (the dispatch pass over the registered entries on
``--device``, the card unless named; the kernel verifier over the
registry; the source lint over the given paths, default
``src/repro_torch``), prints findings, and exits 1 on any UNSUPPRESSED
finding. ``--report`` writes the summary JSON; it has no default file,
so the JAX gate's ``BENCH_check.json`` is never written here.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.check.findings import Finding, RULES

DEFAULT_PATHS = ("src/repro_torch",)


def run_all(paths: Sequence[str] = DEFAULT_PATHS,
            rules: Optional[Sequence[str]] = None, device=None,
            budget: Optional[int] = None) -> Dict:
    """All three passes (only those with a rule in ``rules``, where
    given); returns the structured report dict. ``budget`` is the shared
    memory a block may opt in to (the H100's by default;
    ``chip_smoke.py`` passes the card's own)."""
    # imports deferred so `--help` (and source-only runs) stay instant
    from repro_torch.analysis.check.dispatch_pass import check_dispatch
    from repro_torch.analysis.check.entries import build_entries
    from repro_torch.analysis.check.kernel_pass import (SMEM_BUDGET_BYTES,
                                                        check_all_kernels)
    from repro_torch.analysis.check.source_pass import check_source

    def wanted(*prefixes) -> bool:
        return not rules or any(r.startswith(prefixes) for r in rules)

    wall: Dict[str, float] = {"dispatch": 0.0, "kernel": 0.0, "source": 0.0}
    findings: List[Finding] = []

    t0 = time.perf_counter()
    if wanted("NUM"):
        for e in build_entries(device):
            findings += check_dispatch(e.fn, *e.args, entry=e.name,
                                       input_roles=e.roles,
                                       frame_extent=e.frame_extent)
    wall["dispatch"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if wanted("KRN"):
        findings += check_all_kernels(budget or SMEM_BUDGET_BYTES)
    wall["kernel"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if wanted("SRC", "DET"):
        findings += check_source(list(paths))
    wall["source"] = time.perf_counter() - t0

    if rules:
        keep = set(rules)
        findings = [f for f in findings if f.rule_id in keep]

    counts: Dict[str, int] = {rid: 0 for rid in RULES}
    suppressed = 0
    for f in findings:
        if f.suppressed:
            suppressed += 1
        else:
            counts[f.rule_id] = counts.get(f.rule_id, 0) + 1
    return {
        "findings": findings,
        "counts": counts,
        "suppressed": suppressed,
        "unsuppressed": sum(counts.values()),
        "wall_s": wall,
    }


def report_json(report: Dict) -> Dict:
    """The summary view (no Finding objects, stable keys)."""
    return {
        "rules": {rid: report["counts"].get(rid, 0) for rid in RULES},
        "suppressed": report["suppressed"],
        "unsuppressed": report["unsuppressed"],
        "wall_s": {k: round(v, 4) for k, v in report["wall_s"].items()},
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="Static analysis of the port: aten numerics, CUDA "
                    "kernel metadata, source lint.")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files/dirs for the source pass "
                         "(default: src/repro_torch)")
    ap.add_argument("--device", default=None,
                    help="device the entries run on (default: cuda)")
    ap.add_argument("--rules", nargs="+", metavar="RULE",
                    help="restrict to these rule ids")
    ap.add_argument("--report", metavar="FILE",
                    help="write the summary JSON to FILE")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="print suppressed findings too")
    args = ap.parse_args(argv)

    if args.rules:
        unknown = set(args.rules) - set(RULES)
        if unknown:
            ap.error(f"unknown rules: {sorted(unknown)} "
                     f"(known: {sorted(RULES)})")

    report = run_all(args.paths or list(DEFAULT_PATHS), rules=args.rules,
                     device=args.device)

    for f in report["findings"]:
        if f.suppressed and not args.show_suppressed:
            continue
        print(f.format())
    n_bad = report["unsuppressed"]
    w = report["wall_s"]
    print(f"repro-check: {n_bad} finding(s), "
          f"{report['suppressed']} suppressed "
          f"[dispatch {w['dispatch']:.2f}s, kernel {w['kernel']:.2f}s, "
          f"source {w['source']:.2f}s]")
    if args.report:
        with open(args.report, "w") as fh:
            json.dump(report_json(report), fh, indent=2, sort_keys=True)
            fh.write("\n")
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
