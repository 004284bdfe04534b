"""The port's profiler spans (utils/profiling.py) on the CPU.

* `extract_many(batch_size=2)` on the hashed route (K6 and K3 through
  their plain versions) records every extraction span once per unit,
  nested as the pipeline runs them, and one id per unit shared by its
  `prep` (in the prep thread, seen through `device_trace`), `enqueue` and
  `finish`.
* A `ClusterDescriptorServer` call records `serve.h2d`, and on K3's route
  `serve.pack`, with the request's id.
* A fused training step on the fused towers records `train.step` and its
  six children once each, the wrappers of K1, K2 and K7-K10 inside them,
  and `prefetch` records `data.wait` and, in its thread, `data.upload`.
* Each kernel wrapper opens its `f3d.k<n>.*` span on every call, on the
  CPU's plain version too.
* With no profiler, no span opens a range.
Small widths (ns 8), clouds of 500-700 points (bucket 4 096).
"""
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from feat3dnet_tpu_torch.config import InferenceConfig, ModelConfig, TrainConfig
from feat3dnet_tpu_torch.data.datagenerator import prefetch
from feat3dnet_tpu_torch.inference import ClusterDescriptorServer, InferencePipeline
from feat3dnet_tpu_torch.models import Feat3DNet
from feat3dnet_tpu_torch.ops import (batch_group, fps, fused_describe, fused_train, hash_grid,
                                     interpolate)
from feat3dnet_tpu_torch.train import init_state, make_fused_train_step
from feat3dnet_tpu_torch.utils import init_variables, profiling

torch.set_num_threads(2)

MODEL = dict(num_clusters=-1, num_samples=8, feature_dim=16, base_scale=2.0,
             detector_mlp=(8, 16), detector_mlp2=(8,), descriptor_mlp=(8, 8))
INFER = dict(keypoint_chunk=256, max_keypoints=32, nms_radius=1.0, use_hashed_grouping=True,
             use_fused_detector=True)
TRAIN = dict(num_clusters=8, num_samples=8, feature_dim=16, base_scale=10.0,
             detector_mlp=(8,), detector_mlp2=(8,), descriptor_mlp=(8, 8), fused_towers=True)
UNIT_STAGES = ("layout", "group", "detect", "ballmax", "select", "describe", "to_host")
STEP_STAGES = ("augment", "forward", "loss", "backward", "adam", "metrics")


def _spans(prof):
    """The f3d.* ranges of a finished profile: dicts of name (less its id),
    id (or None), start, end and thread."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU or not e.name().startswith("f3d."):
            continue
        name, _, uid = e.name().partition("#")
        out.append({"name": name, "uid": int(uid) if uid else None, "start": e.start_ns(),
                    "end": e.start_ns() + e.duration_ns(), "thread": e.start_thread_id()})
    return out


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


def _inside(child, parent):
    return (child["thread"] == parent["thread"] and parent["start"] <= child["start"]
            and child["end"] <= parent["end"])


def _clouds(n_clouds, seed=0):
    rs = np.random.RandomState(seed)
    return [((rs.rand(500 + 100 * i, 3) - 0.5) * 12.0).astype(np.float32)
            for i in range(n_clouds)]


@pytest.fixture(scope="module")
def pipe():
    cfg = ModelConfig(**MODEL)
    return InferencePipeline(Feat3DNet(cfg), init_variables(cfg, seed=3, bn_perturb=0.1), cfg,
                             InferenceConfig(**INFER), device="cpu")


def test_extract_many_spans_nest_and_share_the_unit_id(pipe, tmp_path):
    with profiling.device_trace(str(tmp_path)) as prof:
        results = pipe.extract_many(_clouds(4), batch_size=2)
    assert len(results) == 4 and all(r.num_keypoints > 0 for r in results)
    spans = _spans(prof)
    enqueue, finish = _named(spans, "f3d.extract.enqueue"), _named(spans, "f3d.extract.finish")
    prep = _named(spans, "f3d.extract.prep")
    assert len(enqueue) == len(finish) == len(prep) == 2
    assert len(_named(spans, "f3d.extract.wait_prep")) == 2
    uids = {s["uid"] for s in enqueue}
    assert len(uids) == 2 and None not in uids
    assert {s["uid"] for s in finish} == {s["uid"] for s in prep} == uids
    main = enqueue[0]["thread"]
    assert all(s["thread"] != main for s in prep)              # the prep thread's
    for unit in enqueue:
        for stage in UNIT_STAGES:
            inner = [s for s in _named(spans, f"f3d.extract.{stage}") if _inside(s, unit)]
            assert len(inner) == 1, (stage, unit["uid"])
        detect = next(s for s in _named(spans, "f3d.extract.detect") if _inside(s, unit))
        describe = next(s for s in _named(spans, "f3d.extract.describe") if _inside(s, unit))
        assert any(_inside(s, detect) for s in _named(spans, "f3d.k6.detect"))
        assert any(_inside(s, describe) for s in _named(spans, "f3d.k3.describe"))
        for kernel, stage in (("f3d.k4.sorted_ball_query", "group"),
                              ("f3d.k5.ball_max", "ballmax")):
            outer = next(s for s in _named(spans, f"f3d.extract.{stage}") if _inside(s, unit))
            assert any(_inside(s, outer) for s in _named(spans, kernel))


def test_main_thread_profile_records_the_main_thread_spans(pipe):
    """A profile of the calling thread alone: every span but the prep
    thread's; `extract` preps its unit on the calling thread."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.extract_many(_clouds(2, seed=1), batch_size=2)
        pipe.extract(_clouds(1, seed=2)[0])
    spans = _spans(prof)
    names = {s["name"] for s in spans}
    assert {f"f3d.extract.{s}" for s in UNIT_STAGES + ("enqueue", "finish", "wait_prep")} <= names
    enqueue, prep = _named(spans, "f3d.extract.enqueue"), _named(spans, "f3d.extract.prep")
    assert len(enqueue) == 2 and len(prep) == 1
    assert prep[0]["uid"] == enqueue[-1]["uid"] and prep[0]["thread"] == enqueue[-1]["thread"]


def test_server_spans_carry_the_request_id(monkeypatch):
    cfg = ModelConfig()                                    # K3 takes the published widths
    torch.manual_seed(0)
    server = ClusterDescriptorServer(Feat3DNet(cfg), device="cpu")
    clusters = np.random.RandomState(0).randn(16, cfg.num_samples, 3).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        server(clusters)                                   # the model path: no pack
        monkeypatch.setattr(server, "_kernel_route", lambda c: True)
        desc, att = server(clusters)                       # K3's route, its plain version
    spans = _spans(prof)
    assert [s["uid"] for s in _named(spans, "f3d.serve.h2d")] == [0, 1]
    assert [s["uid"] for s in _named(spans, "f3d.serve.pack")] == [1]
    assert len(_named(spans, "f3d.k3.describe")) == 1
    want = server.describe_packed(server.pack_clusters(clusters))
    torch.testing.assert_close(desc, want[0])
    torch.testing.assert_close(att, want[1])


def test_train_step_spans_and_the_feed(tmp_path):
    cfg = ModelConfig(**TRAIN)
    model = Feat3DNet(cfg)
    state = init_state(model, TrainConfig(learning_rate=1e-3), cfg, seed=0, device="cpu")
    step = make_fused_train_step(model, 1.0, True, augmentations=("RotateSmall", "Jitter"),
                                 aug_seed=7)
    rs = np.random.RandomState(0)
    batches = [rs.randn(6, 64, 3).astype(np.float32) for _ in range(2)]
    with profiling.device_trace(str(tmp_path)) as prof:
        for clouds in prefetch(iter(batches), transform=torch.from_numpy):
            state, metrics = step(state, clouds)
    assert state.step == 2 and np.isfinite(metrics["loss"].item())
    spans = _spans(prof)
    steps = _named(spans, "f3d.train.step")
    assert [s["uid"] for s in steps] == [0, 1]
    for st in steps:
        for stage in STEP_STAGES:
            assert len([s for s in _named(spans, f"f3d.train.{stage}") if _inside(s, st)]) == 1
        forward = next(s for s in _named(spans, "f3d.train.forward") if _inside(s, st))
        backward = next(s for s in _named(spans, "f3d.train.backward") if _inside(s, st))
        for kernel in ("f3d.k1.fps", "f3d.k2.ball_query", "f3d.k7.stats", "f3d.k8.final"):
            assert any(_inside(s, forward) for s in _named(spans, kernel)), kernel
        for kernel in ("f3d.k9.bwd_top", "f3d.k10.bwd"):
            assert any(_inside(s, backward) for s in _named(spans, kernel)), kernel
    main = steps[0]["thread"]
    waits = _named(spans, "f3d.data.wait")
    uploads = _named(spans, "f3d.data.upload")
    assert len(waits) >= 2 and all(s["thread"] == main for s in waits)
    assert len(uploads) == 2 and all(s["thread"] != main for s in uploads)


def _stub(*args, **kwargs):
    return "plain"


# wrapper, the plain version it calls on CPU tensors, its span, its arguments
# (the first a CPU tensor; the plain version is stubbed, so the rest are
# placeholders)
_CPU = torch.zeros(1, 8, 3)
WRAPPERS = {
    "fps": (fps, "farthest_point_sample", "farthest_point_sample_scan", "f3d.k1.fps",
            (_CPU, 4)),
    "ball_query": (batch_group, "ball_query_fused", "ball_query_plain", "f3d.k2.ball_query",
                   (_CPU, _CPU, 1.0, 4)),
    "sorted_ball_query": (hash_grid, "sorted_ball_query", "sorted_ball_query_plain",
                          "f3d.k4.sorted_ball_query", (_CPU[0], None, _CPU[0], 1.0, 4)),
    "ball_max": (hash_grid, "ball_max_sorted", "ball_max_plain", "f3d.k5.ball_max",
                 (_CPU[0], None, _CPU[0, :, 0], 1.0)),
    "fused_describe": (fused_describe, "fused_describe_clusters_t",
                       "fused_describe_clusters_t_plain", "f3d.k3.describe",
                       ([], _CPU[0], None)),
    "fused_detect": (fused_describe, "fused_detect_clusters", "fused_detect_clusters_plain",
                     "f3d.k6.detect", ([], _CPU, None)),
    "train_stats": (fused_train, "stats_pass", "stats_pass_plain", "f3d.k7.stats",
                    (_CPU, None, (), None, None, 1)),
    "train_final": (fused_train, "final_pass", "final_pass_plain", "f3d.k8.final",
                    (_CPU, None, ())),
    "train_bwd_top": (fused_train, "bwd_top_pass", "bwd_top_pass_plain", "f3d.k9.bwd_top",
                      (_CPU, None, (), None, None, None)),
    "train_bwd": (fused_train, "bwd_pass", "bwd_pass_plain", "f3d.k10.bwd",
                  (_CPU, None, (), None, None, None, None, None, None, None, None, 1)),
    "three_interp": (interpolate, "three_interpolate", "three_interpolate_plain",
                     "f3d.k11.interp", (_CPU, _CPU, _CPU)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_every_wrapper_call_opens_its_span(monkeypatch, name):
    module, wrapper, plain, span_name, args = WRAPPERS[name]
    monkeypatch.setattr(module, plain, _stub)
    fn = getattr(module, wrapper)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert fn(*args) == "plain" and fn(*args) == "plain"
    assert [s["name"] for s in _spans(prof)] == [span_name, span_name]


def test_no_range_without_a_profiler(pipe, monkeypatch):
    """With no profiler running no span opens a range, on any thread
    (the prep and feed threads included)."""
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name.partition("#")[0])
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert profiling.span("f3d.x") is profiling.span("f3d.y", 3)
    with profiling.span("f3d.x"):
        pass
    res = pipe.extract(_clouds(1, seed=3)[0])
    assert res.num_keypoints > 0
    pipe.extract_many(_clouds(2, seed=4), batch_size=2)
    server = ClusterDescriptorServer(pipe.model, device="cpu")
    server(np.zeros((4, 8, 3), np.float32))
    list(prefetch(iter([np.zeros((6, 64, 3), np.float32)]), transform=torch.from_numpy))
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("f3d.x"):
            pass
    assert opened == ["f3d.x"]


def _span_report():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "span_report.py")
    spec = importlib.util.spec_from_file_location("span_report", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_span_report_splits_idle_time_by_the_innermost_span():
    """scripts/span_report.py on a made-up trace (µs): each idle piece goes
    to the latest-starting span open on any thread, else outside the
    program; zero-length events close where they open."""
    from types import SimpleNamespace

    report = _span_report()
    host = [(0.0, 1000.0, "f3d.train.step#4"), (100.0, 400.0, "f3d.train.forward"),
            (300.0, 2500.0, "f3d.data.upload"), (500.0, 500.0, "instant"),
            (2600.0, 4700.0, "aten::item")]
    device = [(0.0, 150.0, "k"), (900.0, 950.0, "k"), (2550.0, 2560.0, "k")]
    trace = SimpleNamespace(host=host, device=device, window=(0.0, 5000.0))
    split, gaps = report.idle_split(trace)
    want = {"f3d.train.forward": 150e-6, "f3d.data.upload": 2150e-6, "f3d.train.step": 0.0,
            report.OUTSIDE: 2490e-6}
    for name, seconds in want.items():
        assert split.get(name, 0.0) == pytest.approx(seconds, abs=1e-9), name
    assert gaps["gaps_over_1ms"] == 2 and gaps["outside_over_1ms"] == 1
    assert gaps["outside_longest"] == [["no host event", pytest.approx(2.44)]]
    assert gaps["outside_by_event_s"] == pytest.approx({"no host event": 390e-6,
                                                        "aten::item": 2100e-6})
