"""Kernel launches the host issued inside the program's ``icp.match``
spans (the matchers, the ``knn.query`` spans in them included) per
``icp.iter`` span: the matchers' share of an ICP iteration's launches,
from the traced window's program spans (``program_trace.py``). Nothing
where the trace has no program section or no ICP iteration."""

from benchmark.program_trace import per_iteration


def read(r):
    return per_iteration(r, "icp.match", "launches_incl")
