"""The six readers of the program's spans (metrics/*.py over spans.py): each
reads a positive value in the CPU's small traced run of its cell, and None
on a trace without its span (the trace of a program that opens none)."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import harness, spans
from portbench.tests.pb_small import small_run

READERS = {"extract-kitti-stream": ("enqueue_ms.stream", "layout_enqueue_ms.stream"),
           "serve-clusters-7680": ("h2d_host_ms.serve",),
           "train-oxford-fused": ("host_step_ms.train", "feed_wait_ms.train",
                                  "wrapper_host_ms.train")}
ALL = sorted(n for names in READERS.values() for n in names)


def test_readers_are_the_benchmarks():
    bench = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for cell, names in READERS.items():
        for n in names:
            assert bench[n]["workloads"] == [cell] and bench[n]["source"] == "device_trace"


@pytest.mark.parametrize("cell", sorted(READERS))
def test_span_readers_read_the_small_traced_run(cell):
    out = small_run(cell, trace=1)
    assert out["correct"]
    for name in READERS[cell]:
        assert out["metrics"][name]["value"] > 0, name


@pytest.mark.parametrize("name", ALL)
def test_span_reader_gives_none_without_its_span(name):
    r = SimpleNamespace(trace=SimpleNamespace(host=[(0.0, 5000.0, "aten::mm"),
                                                    (10.0, 20.0, "f3d.other.stage#3")]),
                        traced={"work": {"steps": 3, "requests": 2, "clouds": 8}})
    assert harness.metric_reader(name).read(r) is None


def test_spans_strip_the_id_and_sum_over_units():
    trace = SimpleNamespace(host=[(0.0, 2000.0, "f3d.train.step#7"),
                                  (3000.0, 7000.0, "f3d.train.step#8"),
                                  (100.0, 600.0, "f3d.k10.bwd"), (700.0, 800.0, "f3d.k1.fps"),
                                  (0.0, 9000.0, "f3d.train.stepper")])
    assert spans.mean_ms(trace, "f3d.train.step") == 3.0
    r = SimpleNamespace(trace=trace, traced={"work": {"steps": 2}})
    assert harness.metric_reader("wrapper_host_ms.train").read(r) == 0.3
    assert spans.per_unit_ms(trace, lambda n: n == "f3d.k1.fps", 0) is None
