"""The kNN's share of its roofline by the program's own records: the sum
of roofline.knn_bound_s over the ``knn.rows`` counter records (the rows
each sweep was handed, as counts on the device) over the sum of the
device time of the kernels launched inside the ``knn.query`` span paired
with each record (``program_trace.py``). Nothing where the program kept
no record or the records and spans do not pair."""


def read(r):
    calls = None if r.trace is None else (r.trace.get("program") or {}).get("knn")
    if not calls:
        return None
    device = sum(d for _, d in calls)
    if device <= 0:
        return None
    return 100.0 * sum(b for b, _ in calls) / device
