"""Kernel launches the host issued in the traced window (cudaLaunchKernel
and its variants, from the trace) per scan served in it."""


def read(r):
    if r.trace is None or not r.scans:
        return None
    return r.trace["launches"] / r.scans
