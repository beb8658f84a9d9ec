"""Kernel launches the host issued inside the program's ``icp.solve``
spans (the solvers: the normal equations' build and solve) per
``icp.iter`` span, from the traced window's program spans
(``program_trace.py``). Nothing where the trace has no program section or
no ICP iteration."""

from benchmark.program_trace import per_iteration


def read(r):
    return per_iteration(r, "icp.solve", "launches_incl")
