"""Device: the model's FLOPs over the untraced window (counted at the
published widths, real points only; portbench/flops.py), over the window's
seconds and the one peak of peaks.json."""


def read(r):
    return r.mfu_pct()
