"""Scans whose pose reached the host in the window, over the window's
seconds (host clock): all the work over all the time. A fleet pass counts
streams x (frames - 1) scans, an align one."""


def read(r):
    return sum(scans for _, _, scans in r.window.requests) / r.window_s
