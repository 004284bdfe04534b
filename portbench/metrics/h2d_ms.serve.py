"""Entry (server): the device's host-to-device copy time per request in the
traced window (torch.profiler's `Memcpy HtoD` activity)."""

KINDS = ("Memcpy HtoD",)


def read(r):
    n = r.traced["work"]["requests"]
    t = r.trace.time_s(KINDS)
    return 1e3 * t / n if n and t > 0 else None
