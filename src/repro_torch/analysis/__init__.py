"""Analysis of the port: the H100 roofline and the fused alignment's
cost model (``roofline``), flops and bytes counted op by op
(``op_cost``), and the check passes (``check``). The counterpart of
``repro/analysis``; it imports torch only."""
from repro_torch.analysis.roofline import (
    HW,
    RooflineReport,
    bound,
    roofline_from_counts,
)

__all__ = ["HW", "RooflineReport", "bound", "roofline_from_counts"]
