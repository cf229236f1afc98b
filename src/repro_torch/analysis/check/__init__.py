"""Static-analysis suite for the port (the counterpart of
``repro/analysis/check``).

Three passes over three layers:

  * :func:`check_dispatch` - run an entry under a dispatch mode and check
    the aten ops it dispatches for numerics hazards (NUM001-NUM004);
  * :func:`check_kernel` - verify a registered CUDA kernel's metadata and
    source: grid cover, output coverage and races, async-copy ring
    discipline, shared memory (KRN001-KRN004);
  * :func:`check_source` - AST lint of the Python source itself
    (SRC001-SRC003, DET001).

``run_all`` runs every pass over the port's registered entries and
kernels plus a source sweep; the CLI (``python -m
repro_torch.analysis.check``) wraps it and exits nonzero on any
unsuppressed finding.
"""
from repro_torch.analysis.check.findings import Finding, Rule, RULES, Severity
from repro_torch.analysis.check.dispatch_pass import check_dispatch
from repro_torch.analysis.check.kernel_pass import (check_all_kernels,
                                                    check_kernel)
from repro_torch.analysis.check.source_pass import check_source
from repro_torch.analysis.check.cli import main, run_all

__all__ = [
    "Finding", "Rule", "RULES", "Severity",
    "check_dispatch", "check_kernel", "check_all_kernels", "check_source",
    "run_all", "main",
]
