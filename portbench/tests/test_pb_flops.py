"""The work counters against hand counts at the published widths."""
from __future__ import annotations

import json
import os

import pytest

from portbench import flops, harness

CFG = harness.load_json(os.path.join(harness.HERE, "configs", "feat3dnet-paper-eval.json"))["model"]


def test_cluster_macs_by_hand():
    # detector: per slot 3*64 + 64*128 + 128*256, 64 slots; post 256*128 + 128*64; heads 64*3
    det = 64 * (3 * 64 + 64 * 128 + 128 * 256) + (256 * 128 + 128 * 64) + 64 * 3
    # descriptor: per slot 3*32 + 32*64 + 128*128, 64 slots; post 128*32
    desc = 64 * (3 * 32 + 32 * 64 + 128 * 128) + 128 * 32
    assert flops.detector_cluster_macs(CFG) == det == 2_674_880
    assert flops.descriptor_cluster_macs(CFG) == desc == 1_189_888
    assert flops.model_macs_per_cluster(CFG) == 3_864_768


def test_extraction_counts_real_points_only():
    # a 29 291-point frame padded to 32 768: the detector at the real points,
    # the descriptor at 1 024 keypoints
    f = flops.extract_flops(CFG, 29_291, 1_024)
    assert f == 2.0 * (29_291 * 2_674_880 + 1_024 * 1_189_888)
    k6_f, k6_b = flops.k6_work(CFG, 29_291)
    assert k6_f == 2.0 * 29_291 * 2_674_880 and k6_b == 4.0 * 29_291 * (64 * 3 + 2)


def test_serving_and_k3_bytes():
    f, b = flops.k3_work(CFG, 7_680)
    assert f == 2.0 * 7_680 * 3_864_768
    assert b == 4.0 * 7_680 * (64 * 3 + 33)


def test_training_counts():
    clouds, rows = 18, 18 * 512 * 64
    fwd = (3 * 64 + 64 * 128 + 128 * 256) + (3 * 32 + 32 * 64 + 128 * 128)
    dx = (64 * 128 + 128 * 256) + (32 * 64 + 128 * 128)
    f, b = flops.towers_work(CFG, clouds)
    assert f == 2.0 * rows * (2 * fwd + dx)
    assert b == 4.0 * (2 * rows * 3 + 2 * clouds * 512 * (256 + 128))
    assert flops.train_step_flops(CFG, clouds) == 2.0 * 3 * clouds * 512 * 3_864_768


def test_bound_takes_the_larger_side():
    p = flops.peaks()
    assert p["flops_per_s"] == 495e12 and p["bytes_per_s"] == 3.35e12
    assert flops.bound_s(495e12, 0.0) == pytest.approx(1.0)
    assert flops.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
