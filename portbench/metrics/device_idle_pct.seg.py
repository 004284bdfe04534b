"""Device: the share of the traced window in which no kernel, copy or set
ran on the card (torch.profiler's CUDA activity, its union)."""


def read(r):
    return r.trace.idle_pct()
