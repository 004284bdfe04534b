"""The cell extract-kitti-stream-default, the pipeline's default route (the
model's own towers on torch ops, no K6 or K3): its small run on the CPU is
correct and traced, its towers' work counts by hand, each fault planted in
the route fails its check, and its control fails on the card."""
from __future__ import annotations

import io
import os

import pytest

from portbench import flops_default, harness
from portbench.tests import test_pb_control as control
from portbench.tests.pb_small import SEED, SMALL

CELL = "extract-kitti-stream-default"
READERS = ("device_idle_pct.default", "mfu.default", "enqueue_ms.default",
           "gemm_share_pct.default", "gemm_roofline_pct.default")


def _small_run(trace: int = 0) -> dict:
    """One run of the cell on the CPU at the stream cell's small sizes."""
    from portbench import run

    over = {k: dict(v) for k, v in SMALL["extract-kitti-stream"].items()}
    return run.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.05",
                     "--trace", str(trace)], device="cpu", overrides=over,
                    stream=io.StringIO())


def test_cell_runs_the_default_route():
    bench = harness.benchmark()
    cell, wl, cfg = harness.cell_spec(CELL, bench)
    _, stream_wl, stream_cfg = harness.cell_spec("extract-kitti-stream", bench)
    assert cell["chips"] == 1 and cell["traffic"] == "kitti-stream"
    assert {k: wl[k] for k in ("traffic", "check")} == \
        {k: stream_wl[k] for k in ("traffic", "check")}
    assert cfg["inference"] == {**stream_cfg["inference"], "use_fused_detector": False}
    assert cfg["model"] == stream_cfg["model"] and cfg["weights"] == stream_cfg["weights"]
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        assert per_layer[name]["workloads"] == [CELL]


def test_small_run_reports_its_own_rate():
    out = _small_run()
    assert out["correct"] and set(out["metrics"]) == {"clouds_per_s_default", "setup_s"}
    assert out["metrics"]["clouds_per_s_default"]["value"] > 0


def test_small_run_is_correct_and_traced():
    out = _small_run(trace=1)
    assert out["correct"] and out["attempted"] >= 2 and out["failed"] == 0
    assert out["metrics"]["enqueue_ms.default"]["value"] > 0
    # no CUDA kernel runs on the CPU: the GEMM readers find nothing to read
    assert "gemm_share_pct.default" not in out["metrics"]
    assert "gemm_roofline_pct.default" not in out["metrics"]


def test_default_towers_work_by_hand():
    cfg = harness.load_json(os.path.join(harness.HERE, "configs",
                                         "feat3dnet-paper-eval-default.json"))["model"]
    f, b = flops_default.default_towers_work(cfg, 29_291, 1_024)
    assert f == 2.0 * (29_291 * 2_674_880 + 1_024 * 1_189_888)
    assert b == 4.0 * (29_291 * (64 * 3 + 2) + 1_024 * (64 * 3 + 32))


FAULT_NUMBER = {"bn_epsilon": "desc_gap", "attention": "kp_att_gap",
                "descriptor": "desc_gap", "half": "kp_set_gap"}


@pytest.mark.parametrize("fault", sorted(FAULT_NUMBER))
def test_faults_fail(monkeypatch, fault):
    """The default route broken underneath, and the check fails: every port
    BatchNorm with epsilon 0 (rsqrt(var) for rsqrt(var + eps), the slip a
    BN-folding rewrite would make); an answer altered where the route
    produces it (the attention of the model's detector, a descriptor of its
    descriptor tower); half of a batch left out."""
    from feat3dnet_tpu_torch.inference.pipeline import InferencePipeline
    from feat3dnet_tpu_torch.models import layers
    from feat3dnet_tpu_torch.models.feat3dnet import Feat3DNet

    if fault == "bn_epsilon":
        init = layers.BatchNorm.__init__

        def no_epsilon(self, *a, **kw):
            init(self, *a, **kw)
            self.epsilon = 0.0

        monkeypatch.setattr(layers.BatchNorm, "__init__", no_epsilon)
    elif fault == "half":
        real = InferencePipeline._finish

        def half(unit):
            res = real(unit)
            n = len(res) // 2
            return res[:len(res) - n] + res[:n]          # the second half gets the first's

        monkeypatch.setattr(InferencePipeline, "_finish", staticmethod(half))
    elif fault == "attention":
        detect = Feat3DNet.detect_clusters

        def altered(self, *a, **kw):
            att, ori = detect(self, *a, **kw)
            return att * 1.001, ori

        monkeypatch.setattr(Feat3DNet, "detect_clusters", altered)
    else:
        describe = Feat3DNet.describe_clusters

        def altered(self, *a, **kw):
            d = describe(self, *a, **kw).clone()
            d[..., 0, :] = -d[..., 0, :]
            return d

        monkeypatch.setattr(Feat3DNet, "describe_clusters", altered)
    out = _small_run()
    number = FAULT_NUMBER[fault]
    assert not out["correct"]
    assert out["checks"][number]["value"] > 10 * out["checks"][number]["limit"]


@pytest.mark.cuda
def test_control_fails(monkeypatch):
    """At the cell's widths on the card: the reference in TF32, put in the
    program's place, fails one of the cell's numbers."""
    monkeypatch.setitem(control.SIZES, CELL, control.SIZES["extract-kitti-stream"])
    control.test_control_fails(CELL)
