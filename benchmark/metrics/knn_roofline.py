"""The kNN front ends' share of their roofline in the traced window, over
every call (``knn_bruteforce``: K1, or K3 above 131072 points;
``knn_bruteforce_batched`` and the front end under torch.func.vmap: K2):
the sum of each call's bound (roofline.knn_bound_s of the valid rows it
was handed) over the sum of the device time of the kernels launched inside
its span. Nothing when a front end or a count is missing, or no call ran."""


def read(r):
    calls = None if r.trace is None else r.trace["knn"]
    if calls is None:
        if r.trace is not None:
            r.log("[knn] a front end or a count is missing in the traced window")
        return None
    device = sum(d for _, d in calls)
    if device <= 0:
        return None
    return 100.0 * sum(b for b, _ in calls) / device
