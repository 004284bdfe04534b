"""Device: PointNet++'s FLOPs over the untraced window (the forward at the
published widths a cloud; portbench/flops_seg.py), over the window's
seconds and the one peak of peaks.json."""


def read(r):
    return r.mfu_pct()
