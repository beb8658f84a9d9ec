"""The share of the ICP loop's host time spent waiting on host reads:
100 x the seconds of the program's ``sync.*`` spans inside ``icp.iter``
spans over the seconds of the ``icp.iter`` spans (``program_trace.py``).
High where the card sets the loop's pace, low where the host's issue
does. Nothing where the trace has no program section or no ICP
iteration."""

from benchmark.program_trace import iterations


def read(r):
    it = iterations(r)
    if it is None or it["seconds"] <= 0:
        return None
    spans = r.trace["program"]["spans"]
    wait = sum(st["under"].get("icp.iter", 0.0) for name, st in spans.items()
               if name.startswith("sync."))
    return 100.0 * wait / it["seconds"]
