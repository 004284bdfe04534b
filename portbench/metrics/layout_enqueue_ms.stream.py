"""Morton layout: the host's milliseconds to queue one unit's layout
(`build_sorted_cloud_batch`, the span `f3d.extract.layout`, the interval
`InferencePipeline.timings["layout_s"]` reads), their mean over the
traced window."""
from portbench import spans


def read(r):
    return spans.mean_ms(r.trace, "f3d.extract.layout")
