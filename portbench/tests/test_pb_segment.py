"""The two cells of PointNet++ and the submap stream (segment-kitti-16k,
extract-submap-stream) on the CPU at small sizes, their work counts, a
planted fault in each check, and their controls on the card."""
from __future__ import annotations

import io

import pytest
import torch

from portbench import flops_seg, harness, run
from portbench.entries.common import Context
from portbench.tests.pb_small import SEED

SMALL = {
    "segment-kitti-16k": {"traffic": {"pool": 2, "warm_frames": 1, "call_frames": 2,
                                      "batch_size": 2},
                          "model": {"num_points": 512, "npoints": [128, 32, 16, 8]},
                          "check": {"sample": 2}},
    "extract-submap-stream": {"traffic": {"pool": 2, "points": 1500, "box_m": [12.0, 12.0, 2.0],
                                          "warm_frames": 1, "call_frames": 2, "batch_size": 2},
                              "check": {"sample": 2}},
}


def _run(cell, trace=0, over=None):
    return run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.05", "--trace",
                     str(trace)], device="cpu", overrides=over or SMALL[cell],
                    stream=io.StringIO())


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_small_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"] and out["attempted"] >= 2 and out["failed"] == 0
    assert out["metrics"]["clouds_per_s"]["value"] > 0


def test_traced_segment_reads_its_metrics():
    out = _run("segment-kitti-16k", trace=1)
    assert {"mfu.seg", "device_idle_pct.seg", "enqueue_ms.seg"} <= set(out["metrics"])


def test_model_work_is_the_published_count():
    _, _, cfg = harness.cell_spec("segment-kitti-16k")
    assert flops_seg.cloud_macs(cfg["model"]) == 7_049_314_304
    assert [lvl[:2] for lvl in flops_seg.fp_levels(cfg["model"])] == [
        (16384, 4096), (4096, 1024), (1024, 256), (256, 64)]
    assert [lvl[3] for lvl in flops_seg.fp_levels(cfg["model"])] == [256, 608, 768, 1536]


def test_segment_check_fails_a_planted_fault(monkeypatch):
    """BN's eps 1e-3 in the program where the configuration says 1e-5."""
    from portbench.entries import segment

    real = segment.port_config
    monkeypatch.setattr(segment, "port_config",
                        lambda m: real({**m, "bn_epsilon": 1e-3}))
    assert not _run("segment-kitti-16k")["correct"]


def test_submap_check_fails_a_planted_fault(monkeypatch):
    """The detector's attention scaled by 1.001 in the program."""
    from feat3dnet_tpu_torch.models import feat3dnet

    real = feat3dnet.Feat3DNet.detect_clusters

    def scaled(self, *a, **kw):
        att, ori = real(self, *a, **kw)
        return att * 1.001, ori

    monkeypatch.setattr(feat3dnet.Feat3DNet, "detect_clusters", scaled)
    over = {**SMALL["extract-submap-stream"], "inference": {"use_fused_detector": False}}
    assert not _run("extract-submap-stream", over=over)["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails(cell):
    """At the cell's widths on the card: the reference in TF32 fails one of
    the check's numbers."""
    if not torch.cuda.is_available():
        pytest.skip("the TF32 controls need a CUDA device")
    _, wl, cfg = harness.cell_spec(cell)
    sizes = {"traffic": {"pool": 8 if cell.startswith("segment") else 4, "warm_frames": 1,
                         "call_frames": 2}}
    c = harness.entry(wl["entry"]).Cell(Context(harness.ROOT, cfg, wl, SEED,
                                               torch.device("cuda"), sizes))
    c.setup()
    c.release()
    numbers = c.numbers(control=True)
    assert any(v > wl["check"]["limits"][k] for k, v in numbers.items()), numbers
