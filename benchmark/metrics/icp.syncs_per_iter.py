"""Host waits in the traced window per ICP iteration in it:
cudaStreamSynchronize + cudaDeviceSynchronize calls + device-to-host copies
(a host read of a device value is one copy and one synchronisation)."""


def read(r):
    if r.trace is None or not r.iterations:
        return None
    return (r.trace["syncs"] + r.trace["dtoh"]) / r.iterations
